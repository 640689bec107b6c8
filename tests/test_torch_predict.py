"""The port's predict CLI (`monoloco_tpu_torch.run.main`) against the JAX
package's predict on the same images, pifpaf JSONs and checkpoint.

Both run f32 on the CPU; values agree to 1e-5 (relative and absolute: two
frameworks, two f32 sum orders), host-side fields (boxes, pixel centres,
keypoints, gt flags, activity flags) exactly; figure outputs file for file
(their content: tests/test_torch_visuals.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from monoloco_tpu import predict as jax_predict
from monoloco_tpu import run as jax_run
from monoloco_tpu_torch import run
from monoloco_tpu_torch.predict import image_size

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
TOL = 1e-5
EXACT = ('gt', 'indices', 'boxes', 'uv_kps', 'uv_centers', 'uv_shoulders', 'uv_heads',
         'social_distance', 'raising_hand')


def _images(root, n):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        dst = os.path.join(root, f'im{i}.png')
        shutil.copy(os.path.join(HERE, 'fixture_002282.png'), dst)
        shutil.copy(os.path.join(HERE, 'fixture_002282.pifpaf.json'), dst + '.pifpaf.json')
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith('.png'))


def _jax_predict(monkeypatch, argv):
    monkeypatch.setattr(sys, 'argv', ['monoloco_tpu.run', *argv])
    jax_predict.predict(jax_run.cli())


def _compare_dirs(ours_dir, ref_dir, n):
    names = sorted(f for f in os.listdir(ref_dir) if f.endswith('.monoloco.json'))
    assert len(names) == n
    assert sorted(f for f in os.listdir(ours_dir) if f.endswith('.monoloco.json')) == names
    for name in names:
        with open(os.path.join(ours_dir, name)) as f:
            ours = json.load(f)
        with open(os.path.join(ref_dir, name)) as f:
            ref = json.load(f)
        assert list(ours.keys()) == list(ref.keys()), name
        for key in ref:
            if key in EXACT:
                assert ours[key] == ref[key], (name, key)
            else:
                np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                           np.asarray(ref[key], np.float64),
                                           rtol=TOL, atol=TOL, err_msg=f'{name}:{key}')


@pytest.mark.parametrize('n_images', [1, 3])
def test_predict_cli_matches_jax(tmp_path, monkeypatch, n_images):
    """1 image takes the per-image loop, 3 the batched chunk path."""
    imgs = _images(str(tmp_path / 'imgs'), n_images)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti',
              '--output_types', 'json']
    net = run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'),
                    '--disable-cuda'])
    assert net.n_dispatches == (1 if n_images == 3 else n_images)
    assert net.n_dispatches_int8 == 0 and net.precision == 'default'
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    _compare_dirs(str(tmp_path / 'ours'), str(tmp_path / 'ref'), n_images)


def test_glob_and_json_dir(tmp_path):
    imgs = _images(str(tmp_path / 'imgs'), 3)
    json_dir = tmp_path / 'poses'
    json_dir.mkdir()
    for p in imgs:
        shutil.move(p + '.pifpaf.json', json_dir / (os.path.basename(p) + '.pifpaf.json'))
    run.main(['predict', '--glob', str(tmp_path / 'imgs' / '*.png'), '--json_dir',
              str(json_dir), '--model', MODEL, '--calibration', 'kitti',
              '-o', str(tmp_path / 'out'), '--disable-cuda'])
    assert len(os.listdir(tmp_path / 'out')) == 3


@pytest.mark.parametrize('name', ['fixture_002282.png', 'fixture_000840.png',
                                  'fixture_frame0032.jpg'])
def test_image_size_reads_headers_like_pillow(name):
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        assert tuple(image_size(path)) == im.size


@pytest.mark.parametrize('argv', [
    ['train', '--joints', 'x.json', '--hyp'],
    ['train', '--joints', 'x.json', '--resume', 'x.pkl'],
    ['eval', '--activity'],
    [],
])
def test_unported_commands_exit_nonzero(argv):
    """No command, or one whose input is missing (the joints file, --dir_ann),
    exits non-zero with a message; `train --hyp`, `--resume` and `eval
    --activity` themselves run."""
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code not in (0, None)


# The first five cases keep their ids from when the port refused all five;
# the figure outputs, --activities and MC dropout now run (`_NOW_RUN`: the
# files each writes).
_NOW_RUN = {'json only': ['.monoloco.json', '.multi.png'],
            'activities': ['.bird.png', '.front.png'],    # default outputs front and bird
            'dropout': ['.multi.png']}


@pytest.mark.parametrize('extra,match', [
    (['--mode', 'stereo'], 'stereo'),            # one image: stereo takes pairs
    (['--output_types', 'json', 'multi'], 'json only'),
    (['--activities', 'raise_hand'], 'activities'),
    (['--n_dropout', '5'], 'dropout'),
    (['--webcam'], 'webcam'),
    (['--mode', 'stereo', '--activities', 'social_distance'], 'stereo'),
    (['--net', 'monoloco', '--activities', 'social_distance'], 'orientation'),
    (['--activities', 'raise_hand', '--output_types', 'multi'], 'front/bird'),
    (['--mode', 'depth'], 'keypoints, mono or stereo'),
])
def test_unported_predict_options_are_refused(tmp_path, extra, match):
    """Options the port does not take, an odd number of stereo images, and
    the combinations the JAX package refuses too; the options the port once
    refused run and write their outputs."""
    imgs = _images(str(tmp_path / 'imgs'), 1)
    if match not in _NOW_RUN:
        with pytest.raises(SystemExit, match=match):
            run.main(['predict', *imgs, '--model', MODEL, *extra])
        return
    net = run.main(['predict', *imgs, '--model', MODEL, '--calibration', 'kitti',
                    '-o', str(tmp_path / 'out'), '--disable-cuda', *extra])
    assert net.n_dispatches == 1
    assert sorted(os.listdir(tmp_path / 'out')) == ['out_im0.png' + o for o in _NOW_RUN[match]]


@pytest.mark.parametrize('module,package', [('matplotlib', 'matplotlib'), ('PIL', 'Pillow')])
def test_a_figure_without_its_package_exits_naming_it(tmp_path, monkeypatch, module, package):
    """Before any net is built: the figure outputs need matplotlib and
    Pillow; a json-only run needs neither."""
    imgs = _images(str(tmp_path / 'imgs'), 1)
    monkeypatch.setitem(sys.modules, module, None)
    built = []
    monkeypatch.setattr('monoloco_tpu_torch.predict.Loco',
                        lambda *a, **k: built.append(1))
    for extra in (['--output_types', 'json', 'multi'], ['--mode', 'keypoints'], []):
        with pytest.raises(SystemExit, match=package):
            run.main(['predict', *imgs, '--model', MODEL, '--disable-cuda', *extra])
    assert not built
    monkeypatch.undo()
    net = run.main(['predict', *imgs, '--model', MODEL, '--disable-cuda', '--output_types',
                    'json', '-o', str(tmp_path / 'out')])
    assert net.n_dispatches == 1


@pytest.mark.parametrize('n_images', [1, 3])
def test_activities_json_matches_jax(tmp_path, monkeypatch, n_images):
    """--activities social_distance raise_hand on the fixture: every key of
    the JSON within 1e-5, the activity flags equal; per image and batched."""
    imgs = _images(str(tmp_path / 'imgs'), n_images)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti',
              '--activities', 'social_distance', 'raise_hand', '--output_types', 'json']
    run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'), '--disable-cuda'])
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    _compare_dirs(str(tmp_path / 'ours'), str(tmp_path / 'ref'), n_images)
    with open(tmp_path / 'ours' / 'out_im0.png.monoloco.json') as f:
        dic = json.load(f)
    assert len(dic['social_distance']) == len(dic['raising_hand']) == len(dic['dds_pred'])


def test_keypoints_mode_matches_jax(tmp_path, monkeypatch):
    """--mode keypoints builds no net: the JSON ({} per image) equals JAX's,
    and without --output_types each image's .keypoints.png is written."""
    imgs = _images(str(tmp_path / 'imgs'), 3)
    for name, extra in (('json', ['--output_types', 'json']), ('png', [])):
        argv = ['predict', *imgs, '--mode', 'keypoints', *extra]
        assert run.main(argv + ['-o', str(tmp_path / f'ours_{name}'), '--disable-cuda']) is None
        _jax_predict(monkeypatch, argv + ['-o', str(tmp_path / f'ref_{name}')])
        ours = sorted(os.listdir(tmp_path / f'ours_{name}'))
        assert ours == sorted(os.listdir(tmp_path / f'ref_{name}'))
    assert ours == [f'out_im{i}.png.keypoints.png' for i in range(3)]
    _compare_dirs(str(tmp_path / 'ours_json'), str(tmp_path / 'ref_json'), 3)
    with open(tmp_path / 'ours_json' / 'out_im0.png.monoloco.json') as f:
        assert json.load(f) == {}
    with Image.open(tmp_path / 'ours_png' / ours[0]) as im:
        assert im.size[0] > 0


@pytest.mark.parametrize('types', [['multi'], ['front', 'bird'], ['json', 'front']])
def test_figure_outputs_match_jax_file_for_file(tmp_path, monkeypatch, types):
    imgs = _images(str(tmp_path / 'imgs'), 1)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti',
              '--output_types', *types]
    run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'), '--disable-cuda'])
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    assert sorted(os.listdir(tmp_path / 'ours')) == sorted(os.listdir(tmp_path / 'ref'))
    assert len(os.listdir(tmp_path / 'ours')) == len(types)


def test_mc_dropout_cli_against_jax(tmp_path, monkeypatch):
    """--n_dropout 4: every key but stds_epi within 1e-5 of JAX; stds_epi
    positive and finite (its random streams are not JAX's)."""
    imgs = _images(str(tmp_path / 'imgs'), 3)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti',
              '--output_types', 'json', '--n_dropout', '4']
    net = run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'), '--disable-cuda'])
    assert net.n_dispatches == 1 and net.mc_last[0][0].shape[0] == 4
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    for name in sorted(os.listdir(tmp_path / 'ref')):
        with open(tmp_path / 'ours' / name) as f:
            ours = json.load(f)
        with open(tmp_path / 'ref' / name) as f:
            ref = json.load(f)
        epi, ref_epi = np.asarray(ours.pop('stds_epi')), np.asarray(ref.pop('stds_epi'))
        assert epi.shape == ref_epi.shape and np.isfinite(epi).all() and (epi > 0).all()
        assert (ref_epi > 0).all()
        for key in ref:
            if key in EXACT:
                assert ours[key] == ref[key], key
            else:
                np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                           np.asarray(ref[key], np.float64),
                                           rtol=TOL, atol=TOL, err_msg=key)


def test_profile_writes_a_chrome_trace(tmp_path):
    imgs = _images(str(tmp_path / 'imgs'), 1)
    run.main(['predict', *imgs, '--model', MODEL, '--output_types', 'json', '--disable-cuda',
              '-o', str(tmp_path / 'out'), '--profile', str(tmp_path / 'prof')])
    with open(tmp_path / 'prof' / 'predict_trace.json') as f:
        trace = json.load(f)
    assert trace['traceEvents']


def test_jax_predict_flags_parse():
    """A JAX predict command line, pifpaf passthroughs included, parses."""
    args = run.cli(['predict', 'a.png', '--checkpoint', 'ck', '--long-edge', '641',
                    '--white-overlay', '--font-size', '8', '--monocolor-connections',
                    '--instance-threshold', '0.2', '--seed-threshold', '0.3',
                    '--precise-rescaling', '--decoder-workers', '2', '--no_save',
                    '--hide_distance', '--dpi', '50', '--z_max', '30', '--show_all',
                    '--threshold_prob', '0.4', '--threshold_dist', '2', '--radii', '0.2', '1',
                    '--camera', '1', '--profile', 'p'])
    assert (args.long_edge, args.white_overlay, args.fast_rescaling, args.radii,
            args.output_types, args.camera) == (641, 0.8, False, [0.2, 1.0], [], 1)


def test_missing_poses_name_the_image(tmp_path):
    img = str(tmp_path / 'lonely.png')
    shutil.copy(os.path.join(HERE, 'fixture_002282.png'), img)
    with pytest.raises(FileNotFoundError, match='lonely.png'):
        run.main(['predict', img, '--model', MODEL, '--disable-cuda'])
