"""The port's figures (`monoloco_tpu_torch/visuals`, `activity.show_activities`)
against the JAX package's on the same `dic_out`, annotations and image.

`Figure.savefig` is replaced by a recorder, so each figure is summarized
when it would be written: its file suffix, and per axis the Rectangle edge
colours, the FancyArrow outlines and colours, the texts and their
positions, every line's marker, colour, width and data, the images and the
limits. The port's summary must equal JAX's (floats rounded to 1e-6).
Model: tests/test_visuals_printer.py."""

import argparse
import json
import os

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt
from matplotlib.figure import Figure
from matplotlib.patches import FancyArrow, Rectangle
import numpy as np
import pytest
from PIL import Image

from monoloco_tpu import activity as jax_activity
from monoloco_tpu.visuals import pifpaf_show as jax_show
from monoloco_tpu.visuals import printer as jax_printer
from monoloco_tpu_torch import activity
from monoloco_tpu_torch.visuals import pifpaf_show, printer

HERE = os.path.dirname(os.path.abspath(__file__))


def _r(values):
    return np.round(np.asarray(values, np.float64), 6).tolist()


def _summary(fig):
    axes = []
    for ax in fig.axes:
        axes.append({
            'rects': [_r(p.get_edgecolor()) for p in ax.patches if isinstance(p, Rectangle)],
            'arrows': [(_r(p.get_xy()), _r(p.get_facecolor())) for p in ax.patches
                       if isinstance(p, FancyArrow)],
            'texts': [(t.get_text(), _r(t.get_position()), _r(matplotlib.colors.to_rgba(
                t.get_color()))) for t in ax.texts],
            'lines': [(str(ln.get_marker()), _r(matplotlib.colors.to_rgba(ln.get_color())),
                       _r(ln.get_linewidth()), _r(ln.get_xdata()), _r(ln.get_ydata()))
                      for ln in ax.lines],
            'images': [np.asarray(im.get_array()).tobytes() for im in ax.images],
            'limits': _r(ax.get_xlim() + ax.get_ylim()),
        })
    return axes


@pytest.fixture
def saved(monkeypatch):
    """[(path, summary)] of every figure saved while the test runs."""
    records = []

    def record(fig, path, *args, **kwargs):
        records.append((str(path), _summary(fig)))

    monkeypatch.setattr(Figure, 'savefig', record)
    yield records
    plt.close('all')


def _annotations():
    with open(os.path.join(HERE, 'fixture_002282.pifpaf.json')) as f:
        return json.load(f)[:3]


def _dic_out(annotations):
    return {
        'dds_pred': [10.0, 20.0, 45.0],
        'stds_ale': [0.5, 1.0, 2.0],
        'stds_epi': [0.3, 0.0, 0.7],
        'angles': [0.3, -0.5, 0.0],
        'xyz_pred': [[1.0, 0.5, 10.0], [-2.0, 0.5, 20.0], [3.0, 0.5, 45.0]],
        'boxes': [[10, 50, 60, 200, 0.9], [300, 40, 360, 210, 0.8], [500, 60, 540, 180, 0.7]],
        'aux': [0.9, 0.1, 0.1],
        'xyz_real': [[1.1, 0.5, 10.5]],
        'dds_real': [10.5],
        'gt': [True, False, True],
        'indices': [2, 0, 1],
        'uv_heads': [[30, 60], [330, 50], [520, 70]],
        'uv_shoulders': [[30, 80], [330, 75], [520, 90]],
        'social_distance': [True, False, True],
        'raising_hand': ['left', None, 'both'],
    }


def _args(output_types, **kw):
    base = dict(output_types=output_types, z_max=100, show_all=False, no_save=False,
                hide_distance=False, activities=[], dpi=100)
    base.update(kw)
    return argparse.Namespace(**base)


def _draw_printer(module, output_types, kw):
    image = Image.new('RGB', (640, 480), (90, 120, 150))
    anns = _annotations()
    dic = _dic_out(anns)
    p = module.Printer(image, '/nonexistent/out_img.png', kk=[[720., 0., 320.],
                                                              [0., 720., 240.], [0., 0., 1.]],
                       args=_args(output_types, **kw))
    figures, axes = p.factory_axes(dic)
    p.draw(figures, axes, image, dic, annotations=anns)
    return p


@pytest.mark.parametrize('output_types,kw', [
    (['multi'], {}),
    (['front'], {}),
    (['bird'], {}),
    (['front', 'bird'], {}),
    (['front', 'bird'], {'show_all': True, 'hide_distance': True}),
    (['multi'], {'activities': ['social_distance', 'raise_hand']}),
    (['front', 'bird'], {'activities': ['social_distance'], 'z_max': 30}),
], ids=['multi', 'front', 'bird', 'front-bird', 'show-all-hide-distance', 'multi-activities',
        'front-bird-social-distance'])
def test_printer_matches_jax(saved, output_types, kw):
    ours = _draw_printer(printer, output_types, kw)
    n = len(saved)
    theirs = _draw_printer(jax_printer, output_types, kw)
    assert n > 0 and saved[:n] == saved[n:]
    assert ours.z_max == theirs.z_max and ours._fig_suffixes == theirs._fig_suffixes
    assert [path[len('/nonexistent/out_img.png'):] for path, _ in saved[:n]] == ours._fig_suffixes
    summary = saved[0][1]
    assert any(axis['rects'] or axis['lines'] for axis in summary)


def test_printer_z_max_and_suffixes_match_jax():
    dic = _dic_out(_annotations())
    image = Image.new('RGB', (320, 240))
    for types in (['bird'], ['front', 'multi'], ['front', 'bird']):
        ours = printer.Printer(image, 'x', None, _args(types))
        theirs = jax_printer.Printer(image, 'x', None, _args(types))
        ours.factory_axes(dic)
        theirs.factory_axes(dic)
        assert ours.z_max == theirs.z_max == 49
        assert ours._fig_suffixes == theirs._fig_suffixes
    plt.close('all')


@pytest.mark.parametrize('output_types,activities', [
    (['front', 'bird'], ['social_distance', 'raise_hand']),
    (['front'], ['raise_hand']),
    (['bird'], ['social_distance']),
])
def test_show_activities_matches_jax(saved, output_types, activities):
    image = Image.new('RGB', (640, 480), (40, 80, 120))
    anns = _annotations()
    args = _args(output_types, activities=activities)
    activity.show_activities(args, image, '/nonexistent/out_img.png', anns, _dic_out(anns))
    n = len(saved)
    jax_activity.show_activities(args, image, '/nonexistent/out_img.png', anns, _dic_out(anns))
    assert n == len(output_types) and saved[:n] == saved[n:]
    suffixes = [path[len('/nonexistent/out_img.png'):] for path, _ in saved[:n]]
    assert suffixes == [f'.{t}.png' for t in output_types]


def test_keypoints_canvas_matches_jax(saved):
    """The --mode keypoints figure: the skeletons over the image."""
    image = Image.new('RGB', (1238, 374), (10, 20, 30))
    anns = _annotations()
    for module in (pifpaf_show, jax_show):
        kps, boxes = module.get_pifpaf_outputs(anns)
        with module.image_canvas(image, '/nonexistent/x.keypoints.png') as ax:
            module.KeypointPainter(show_box=True).keypoints(ax, kps)
    assert len(saved) == 2 and saved[0] == saved[1]
    ours, theirs = pifpaf_show.get_pifpaf_outputs(anns), jax_show.get_pifpaf_outputs(anns)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]
    assert pifpaf_show.get_pifpaf_outputs([])[0].shape == (0, 17, 3)


def test_blurred_canvas_matches_jax(saved):
    image = np.random.default_rng(0).integers(0, 256, size=(40, 60, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pifpaf_show._gaussian_blur(image),
                                  jax_show._gaussian_blur(image))
    for module in (pifpaf_show, jax_show):
        with module.blurred_canvas(image, '/nonexistent/blur.png'):
            pass
    assert len(saved) == 2 and saved[0] == saved[1]


def test_colours_and_orientation_helpers_match_jax(saved):
    dic = _dic_out(_annotations())
    colors = ['deepskyblue'] * 3
    assert printer.social_distance_colors(colors, dic) == \
        jax_printer.social_distance_colors(colors, dic) == ['r', 'deepskyblue', 'r']
    for module in (printer, jax_printer):
        fig, ax = plt.subplots()
        module.draw_orientation(ax, [[10, 20], [30, 40]], [12], [0.4, -1.0], ['r'], mode='front')
        module.draw_orientation(ax, [[1, 5], [2, 8]], [], [0.4, -1.0], ['r', 'g'], mode='bird')
        module.draw_uncertainty(ax, [[1, 5], [2, 8]], [0.5, 1.5], color='coral')
        fig.savefig('/nonexistent/helpers.png')
    assert len(saved) == 2 and saved[0] == saved[1]
