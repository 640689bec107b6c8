"""The port's host copies for KITTI eval against the JAX package, on fuzzed
inputs from numpy seeds: `utils/kitti.py`, `utils/misc.py`, the IoU
additions of `geometry/iou.py`, `correct_angle` and `to_spherical`,
`prep.parse_ground_truth`, `prep.factory_file` and `save_txts`' baseline
rows.

Everything is host arithmetic on the same floats, so it is held equal,
except `correct_angle`/`to_spherical` and the parsed labels, held within
1e-6 (the JAX versions are the same `math` expressions; the bound allows a
libm difference, none is seen). Files are written and read under tmp_path.
"""

import json
import math
import os

import numpy as np
import pytest

from monoloco_tpu import geometry as jax_geometry
from monoloco_tpu import utils as jax_utils
from monoloco_tpu.eval import eval_kitti as jax_eval_kitti
from monoloco_tpu.eval import generate_kitti as jax_generate_kitti
from monoloco_tpu.prep import factory_file as jax_factory_file
from monoloco_tpu.prep import parse_ground_truth as jax_parse_ground_truth
from monoloco_tpu_torch import geometry, utils
from monoloco_tpu_torch.eval import eval_kitti, generate_kitti
from monoloco_tpu_torch.prep import factory_file, parse_ground_truth
from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset

SEEDS = [0, 1, 2]
TOL = 1e-6
CLUSTERS = ('3', '5', '7', '9', '11', '13', '15', '17', '19', '21', '23', '25', '27', '29',
            '31', '49')


def _boxes(rng, m, conf=True):
    xy = rng.uniform(0, 1000, size=(m, 2))
    wh = rng.uniform(5, 200, size=(m, 2))
    out = np.concatenate([xy, xy + wh], axis=1)
    if conf:
        out = np.concatenate([out, rng.uniform(0, 1, size=(m, 1))], axis=1)
    return out.tolist()


def _gt_line(rng, cat=None):
    cat = cat or rng.choice(['Pedestrian', 'Cyclist', 'Car', 'Person_sitting', 'DontCare'])
    x, y, z = rng.uniform(-10, 10), rng.uniform(0.5, 2), rng.uniform(3, 60)
    ry = rng.uniform(-3.0, 3.0)
    alpha = ry - math.atan2(x, z)
    alpha = (alpha + math.pi) % (2 * math.pi) - math.pi
    box = rng.uniform(0, 1000, size=2)
    return (f"{cat} {rng.uniform(0, 1):.2f} {rng.randint(0, 4)} {alpha:.2f} "
            f"{box[0]:.2f} {box[1]:.2f} {box[0] + rng.uniform(5, 100):.2f} "
            f"{box[1] + rng.uniform(5, 200):.2f} {rng.uniform(1.4, 1.9):.2f} 0.65 0.80 "
            f"{x:.2f} {y:.2f} {z:.2f} {ry:.2f}\n")


@pytest.mark.parametrize('seed', SEEDS)
def test_check_conditions_is_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        line = _gt_line(rng)
        fields = line.split() + [str(rng.uniform(-1, 1))]
        for category in ('pedestrian', 'cyclist', 'all'):
            assert utils.check_conditions(line, category, 'gt') == \
                jax_utils.check_conditions(line, category, 'gt')
            thresh = float(rng.uniform(-0.5, 0.5))
            assert utils.check_conditions(fields, category, 'monoloco_pp', thresh) == \
                jax_utils.check_conditions(fields, category, 'monoloco_pp', thresh)


@pytest.mark.parametrize('seed', SEEDS)
def test_difficulty_and_cluster_are_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(500):
        box = _boxes(rng, 1, conf=False)[0]
        trunc, occ = float(rng.choice([0, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.7])), rng.randint(0, 4)
        assert utils.get_difficulty(box, trunc, occ) == jax_utils.get_difficulty(box, trunc, occ)
        dd = float(rng.choice([rng.uniform(0, 60), rng.randint(0, 60)]))
        assert utils.find_cluster(dd, CLUSTERS) == jax_utils.find_cluster(dd, CLUSTERS)


def test_misc_helpers_are_jax(tmp_path):
    rng = np.random.RandomState(3)
    for dd in rng.uniform(1, 80, size=50):
        assert utils.get_task_error(dd) == jax_utils.get_task_error(dd)
        assert utils.get_pixel_error(dd) == jax_utils.get_pixel_error(dd)
        lab = rng.uniform(0, 2, size=11).tolist()
        assert utils.normalize_hwl(lab) == jax_utils.normalize_hwl(lab)
    values = rng.uniform(0, 1, size=17).tolist()
    assert utils.average(values) == jax_utils.average(values)
    from collections import defaultdict
    dics = [defaultdict(lambda: {'clst': defaultdict(lambda: defaultdict(list))})
            for _ in range(2)]
    for dd in (5., 10., 10.5, 25., 40., 41.):
        for dic, fn in zip(dics, (utils.append_cluster, jax_utils.append_cluster)):
            fn(dic, 'train', [dd], [0, 0, 0, dd], [[dd]])
    assert {k: dict(v) for k, v in dics[0]['train']['clst'].items()} == \
        {k: dict(v) for k, v in dics[1]['train']['clst'].items()}
    out = tmp_path / 'out'
    out.mkdir()
    (out / 'stale.txt').write_text('x')
    utils.make_new_directory(str(out))
    assert out.is_dir() and not os.listdir(out)


def test_splits_and_basenames_are_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_dataset('.', n_train=6, n_val=5, seed=4, hard=True, images=False)
    gt_names = tuple(os.listdir(os.path.join('data', 'kitti', 'gt')))
    splits = (os.path.join('splits', 'kitti_train.txt'), os.path.join('splits', 'kitti_val.txt'))
    ours = utils.split_training(gt_names, *splits)
    ref = jax_utils.split_training(gt_names, *splits)
    assert [sorted(s) for s in ours] == [sorted(s) for s in ref] and len(ours[1]) == 5
    gt_dir = os.path.join('data', 'kitti', 'gt')
    assert utils.factory_basename('annotations', gt_dir) == \
        jax_utils.factory_basename('annotations', gt_dir)


def test_calibration_and_annotation_loading_are_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_dataset('.', n_train=2, n_val=2, seed=5, images=False)
    for name in sorted(os.listdir(os.path.join('data', 'kitti', 'calib'))):
        path = os.path.join('data', 'kitti', 'calib', name)
        assert utils.get_calibration(path) == jax_utils.get_calibration(path)
        basename = os.path.splitext(name)[0]
        for side in ('left', 'right'):
            assert factory_file(path, 'annotations', basename, side) == \
                jax_factory_file(path, 'annotations', basename, side)
    pp = np.random.RandomState(6).uniform(-5, 700, size=(3, 4))
    assert utils.get_translation(pp) == jax_utils.get_translation(pp)
    path = tmp_path / 'simple.txt'
    path.write_text('P_rect: 1 2 3\nK_02: ' + ' '.join(str(v) for v in range(9)) + '\n')
    assert utils.get_simplified_calibration(str(path)) == \
        jax_utils.get_simplified_calibration(str(path))


def test_rewrites_are_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(7)
    src = tmp_path / 'src.txt'
    src.write_text(''.join(_gt_line(rng) for _ in range(9)) + 'Pedestrian ' + '1 ' * 17 + '\n')
    for fn, jax_fn in ((utils.read_and_rewrite, jax_utils.read_and_rewrite),
                       (utils.strip_to_devkit_columns, jax_utils.strip_to_devkit_columns)):
        for source in (src, tmp_path / 'missing.txt'):
            fn(str(source), str(tmp_path / 'ours.txt'))
            jax_fn(str(source), str(tmp_path / 'ref.txt'))
            assert (tmp_path / 'ours.txt').read_bytes() == (tmp_path / 'ref.txt').read_bytes()


@pytest.mark.parametrize('seed', SEEDS)
def test_iou_additions_are_jax(seed):
    rng = np.random.RandomState(seed)
    for m, n in ((0, 3), (3, 0), (1, 1), (5, 7), (12, 4)):
        boxes, boxes_gt = _boxes(rng, m), _boxes(rng, n, conf=False)
        if m and n:
            # Overlapping pairs, so that the matchers have work.
            boxes_gt[0] = [v + 3 for v in boxes[0][:4]]
        np.testing.assert_array_equal(geometry.get_iou_matrix(boxes, boxes_gt),
                                      jax_geometry.get_iou_matrix(boxes, boxes_gt))
        for thresh in (0.0, 0.15, 0.3):
            assert geometry.get_iou_matches_matrix(boxes, boxes_gt, thresh) == \
                jax_geometry.get_iou_matches_matrix(boxes, boxes_gt, thresh)
        if m and n:
            assert geometry.calculate_iou(boxes[0][:4], boxes_gt[0]) == \
                jax_geometry.calculate_iou(boxes[0][:4], boxes_gt[0])


@pytest.mark.parametrize('seed', SEEDS)
def test_get_category_is_jax(tmp_path, seed):
    """Cyclist flags from bike boxes under the lower body, some centred on a
    person's hips and knees; an absent file flags nobody."""
    rng = np.random.RandomState(seed)
    kps = rng.uniform(0, 1, size=(8, 3, 17))
    kps[:, 0] = kps[:, 0] * 60 + rng.uniform(0, 1000, size=(8, 1))
    kps[:, 1] = kps[:, 1] * 150 + rng.uniform(0, 200, size=(8, 1))
    lower = [[k[0, 9:].min(), k[1, 9:].min(), k[0, 9:].max(), k[1, 9:].max()] for k in kps]
    bikes = [[b[0] + rng.uniform(-5, 5), b[1], b[2] + rng.uniform(-5, 5), b[3] + 10]
             for b in lower[:4]] + _boxes(rng, 3, conf=False)
    path = tmp_path / 'byc.json'
    path.write_text(json.dumps({'boxes': bikes}))
    ours = geometry.get_category(kps.tolist(), str(path))
    assert ours == jax_geometry.get_category(kps.tolist(), str(path)) and sum(ours) >= 1
    assert geometry.get_category(kps.tolist(), str(tmp_path / 'none.json')) == [0.0] * 8
    assert geometry.open_annotations(str(path)) == jax_geometry.open_annotations(str(path))


@pytest.mark.parametrize('seed', SEEDS)
def test_correct_angle_and_to_spherical_are_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(1000):
        xyz = [rng.uniform(-20, 20), rng.uniform(-3, 3), rng.uniform(-5, 80)]
        yaw = rng.uniform(-math.pi, math.pi)
        np.testing.assert_allclose(geometry.correct_angle(yaw, xyz),
                                   jax_geometry.correct_angle(yaw, xyz), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(geometry.to_spherical(xyz), jax_geometry.to_spherical(xyz),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize('spherical', [False, True])
@pytest.mark.parametrize('category', ['pedestrian', 'all'])
def test_parse_ground_truth_is_jax(tmp_path, category, spherical):
    """Synthetic gt files (the generator's, easy and hard, plus fuzzed
    lines of every KITTI class): labels within 1e-6, the rest equal."""
    rng = np.random.RandomState(8)
    make_dataset(str(tmp_path / 'easy'), n_train=3, n_val=3, seed=9, images=False)
    make_dataset(str(tmp_path / 'hard'), n_train=3, n_val=3, seed=9, hard=True, images=False)
    fuzz = tmp_path / 'fuzz.txt'
    fuzz.write_text(''.join(_gt_line(rng) for _ in range(40)))
    paths = [str(fuzz)] + [os.path.join(tmp_path, mode, 'data', 'kitti', 'gt', name)
                           for mode in ('easy', 'hard') for name in ('000001.txt', '000005.txt')]
    n_rows = 0
    for path in paths:
        ours = parse_ground_truth(path, category, spherical=spherical)
        ref = jax_parse_ground_truth(path, category, spherical=spherical)
        boxes, labels, truncs, occs, raw = ours
        assert (boxes, truncs, occs, raw) == (ref[0], ref[2], ref[3], ref[4])
        assert len(labels) == len(ref[1])
        for lab, lab_ref in zip(labels, ref[1]):
            assert lab[-1] == lab_ref[-1]
            np.testing.assert_allclose(lab[:-1], lab_ref[:-1], rtol=TOL, atol=TOL)
        n_rows += len(labels)
    assert n_rows > 10


@pytest.mark.parametrize('net', ['monoloco', 'geometric', 'baseline'])
def test_save_txts_baseline_rows_are_jax(tmp_path, net):
    """The rows of the legacy-net, geometric and stereo-baseline formats,
    byte for byte (GenerateKitti's MonoLoco++/MonStereo rows: the
    generate tests)."""
    rng = np.random.RandomState(10)
    m = 5
    boxes = _boxes(rng, m)
    kk = [[721.5, 0., 609.6], [0., 721.5, 172.9], [0., 0., 1.]]
    tt = rng.uniform(-0.1, 0.1, size=3).tolist()
    xy_centers = rng.uniform(-0.5, 0.5, size=(m, 3))
    xy_centers[:, 2] = 1.0
    bis, epis = rng.uniform(0.2, 2, size=(m, 1)), rng.uniform(0, 1, size=m).tolist()
    zzs_geom = rng.uniform(3, 40, size=m).tolist()
    if net == 'baseline':
        first = (xy_centers * np.array(zzs_geom)[:, None]).tolist()
    else:
        first = rng.uniform(3, 40, size=(m, 1))
    outputs = [first, bis, epis, zzs_geom, xy_centers]
    cat = rng.choice([0.0, 1.0], size=m).tolist()
    generate_kitti.save_txts(str(tmp_path / 'ours.txt'), boxes, outputs, [kk, tt], net, cat)
    jax_generate_kitti.save_txts(str(tmp_path / 'ref.txt'), boxes, outputs, [kk, tt], net, cat)
    assert (tmp_path / 'ours.txt').read_bytes() == (tmp_path / 'ref.txt').read_bytes()
    assert len((tmp_path / 'ours.txt').read_text().splitlines()) == m


def test_cluster_stats_and_extract_indices_are_jax():
    rng = np.random.RandomState(11)
    for method in ('monoloco_pp', 'm3d'):
        for errors in ([], rng.uniform(0, 5, size=9).tolist()):
            stds = {k: rng.uniform(0, 1, size=len(errors)).tolist()
                    for k in ('ale', 'epi', 'epi_rel', 'interval', 'at_risk', 'prec_1',
                              'prec_2')}
            ours, ref = {}, {}
            eval_kitti._cluster_stats(ours, errors, stds, method)
            jax_eval_kitti._cluster_stats(ref, errors, stds, method)
            assert ours == ref
    matches = [[(0, 1), (2, 3)], [(1, 1), (4, 2)], [(5, 1)]]
    for idx in range(5):
        assert eval_kitti.extract_indices(idx, *matches) == \
            jax_eval_kitti.extract_indices(idx, *matches)
