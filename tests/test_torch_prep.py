"""The port's prep (`monoloco_tpu_torch.prep`, `run prep`) against the JAX
package's, on the CPU.

KITTI: on a synthetic tree from the port's `tools/make_synthetic_kitti.py`
(hard mode, images written, so that image sizes come from the PNG headers
in the port and from Pillow in the JAX package), the port's `run prep`
writes the same joints and names JSON files as the JAX `PreprocessKitti`,
mono and stereo, and `--activity` the same gt_activity files. Both sides
are numpy on the host (the K^-1 normalization, the seeded stereo cascade,
the height resampling), so the comparison is exact: the parsed JSON
documents are equal, floats bit for bit, and the activity files byte for
byte.

nuScenes: `PreprocessNuscenes` on `tests/mock_nuscenes_devkit.py`, as
`tests/test_prep_nuscenes.py` drives the JAX one, equal JSON again.
"""

import json
import math
import os

import numpy as np
import pytest

import mock_nuscenes_devkit as mock
from monoloco_tpu.geometry.camera import project_3d as jax_project_3d
from monoloco_tpu.geometry.camera import to_cartesian as jax_to_cartesian
from monoloco_tpu.prep import preprocess_nu as jax_nu
from monoloco_tpu.prep import transforms as jax_tf
from monoloco_tpu.prep.preprocess_kitti import PreprocessKitti as JaxPreprocessKitti
from monoloco_tpu_torch import run
from monoloco_tpu_torch.geometry.host import project_3d, to_cartesian
from monoloco_tpu_torch.prep import preprocess_nu as nu
from monoloco_tpu_torch.prep import transforms as tf
from monoloco_tpu_torch.tools import make_synthetic_kitti


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti')
    make_synthetic_kitti.make_dataset(str(root), n_train=14, n_val=6, seed=5, hard=True,
                                      images=True)
    return root


def _read_and_remove(*paths):
    out = []
    for path in paths:
        with open(path) as f:
            out.append(json.load(f))
        os.remove(path)
    return out


@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_kitti_prep_writes_the_jax_files(kitti_root, monkeypatch, mode):
    monkeypatch.chdir(kitti_root)
    ours = run.main(['prep', '--dir_ann', 'annotations', '--mode', mode])
    joints, names = _read_and_remove(ours.path_joints, ours.path_names)
    theirs = JaxPreprocessKitti('annotations', mode=mode)
    theirs.run()
    j_joints, j_names = _read_and_remove(theirs.path_joints, theirs.path_names)
    assert len(joints['train']['X']) > 20 and len(joints['val']['X']) > 5
    assert joints == j_joints
    assert names == j_names
    assert dict(ours.stats) == dict(theirs.stats)
    assert dict(ours.stats_stereo) == dict(theirs.stats_stereo)
    if mode == 'stereo':
        # The seeded height resampling ran: more rows than matched pairs.
        assert ours.stats_stereo['pair_aug'] > ours.stats_stereo['pair'] > 0


def test_kitti_prep_activity_writes_the_jax_files(kitti_root, monkeypatch):
    monkeypatch.chdir(kitti_root)
    out_dir = os.path.join('data', 'kitti', 'gt_activity')
    run.main(['prep', '--dir_ann', 'annotations', '--activity'])
    ours = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), 'rb') as f:
            ours[name] = f.read()
    JaxPreprocessKitti('annotations').process_activity()
    theirs = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), 'rb') as f:
            theirs[name] = f.read()
    assert len(ours) == 6 and ours == theirs
    lines = [line for v in ours.values() for line in v.decode().splitlines()]
    assert lines and all(line[-2:] in (' 0', ' 1') for line in lines)


# ---------------------------------------------------------------------------
# The transforms and the host geometry they use
# ---------------------------------------------------------------------------

def _poses(rng, m):
    kps = np.stack([rng.uniform(100, 1100, (m, 17)), rng.uniform(50, 350, (m, 17)),
                    rng.uniform(0, 1, (m, 17))], axis=1)
    return kps


def _label(rng, s_match):
    xyz = [rng.uniform(-5, 5), rng.uniform(0.5, 2), rng.uniform(4, 28)]
    r = math.sqrt(sum(v * v for v in xyz))
    yaw = rng.uniform(-math.pi, math.pi)
    theta, psi = math.atan2(xyz[2], xyz[0]), math.acos(xyz[1] / r)
    return [theta, psi, xyz[2], r, 1.7, 0.6, 0.8, math.sin(yaw), math.cos(yaw), yaw, s_match]


@pytest.mark.parametrize('seed', [0, 1, 7, 42, 1234])
@pytest.mark.parametrize('s_match', [1.0, 0.0], ids=['true_pair', 'negative'])
def test_height_augmentation_matches_jax(seed, s_match):
    rng = np.random.default_rng(seed)
    kps, kps_r = _poses(rng, 1), _poses(rng, 1)
    label = _label(rng, s_match)
    ours = tf.height_augmentation(kps, kps_r, label, seed=seed)
    theirs = jax_tf.height_augmentation(kps, kps_r, label, seed=seed)
    assert len(ours[0]) == len(theirs[0]) == (4 if s_match else 2)
    assert ours[1] == theirs[1]
    for (a, b), (c, d) in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_flips_and_host_geometry_match_jax():
    rng = np.random.default_rng(3)
    kps = _poses(rng, 4).tolist()
    boxes = [[float(v) for v in rng.uniform(0, 600, 4)] + [0.9] for _ in range(4)]
    assert tf.transform_keypoints(kps, 'flip') == jax_tf.transform_keypoints(kps, 'flip')
    assert tf.flip_inputs(kps, im_w=1242) == jax_tf.flip_inputs(kps, im_w=1242)
    assert tf.flip_inputs(boxes, im_w=1242, mode='box') == \
        jax_tf.flip_inputs(boxes, im_w=1242, mode='box')
    labels = [_label(rng, 1.0)[:10] for _ in range(4)]
    assert tf.flip_labels(boxes, labels, im_w=1242) == \
        jax_tf.flip_labels(boxes, labels, im_w=1242)
    for lab in labels:
        rtp = lab[3:4] + lab[0:2]
        assert to_cartesian(rtp) == jax_to_cartesian(rtp)
    box = mock.Box('human.pedestrian.adult', (1.0, 1.5, 12.0), (0.7, 0.8, 1.8), 0.3)
    assert project_3d(box, mock.KK) == jax_project_3d(box, mock.KK)


# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------

def test_nuscenes_helpers_match_jax():
    for yaw in (0.0, 0.7, -2.0):
        q = mock.Quaternion(yaw)
        assert nu.quaternion_yaw(q) == jax_nu.quaternion_yaw(q)
        assert nu.quaternion_yaw(q, in_image_frame=False) == \
            jax_nu.quaternion_yaw(q, in_image_frame=False)
    boxes = [b for sd in mock.all_sd_tokens()[:6] for b in mock.boxes_for(sd)]
    assert len(boxes) > 3
    for spherical in (True, False):
        assert nu.extract_ground_truth(boxes, mock.KK, spherical) == \
            jax_nu.extract_ground_truth(boxes, mock.KK, spherical)
    rng = np.random.default_rng(2)
    inputs = rng.normal(size=(4, 34)).tolist()
    keypoints = _poses(rng, 4).tolist()
    ys = [[0, 0, 0, float(d)] for d in rng.uniform(5, 30, 4)]
    for matches in ([(0, 0), (1, 1), (2, 2), (3, 3)], [(0, 0), (2, 1)], [(1, 0)]):
        for idx in range(4):
            assert nu.extract_social(inputs, ys, keypoints, idx, matches) == \
                jax_nu.extract_social(inputs, ys, keypoints, idx, matches)


def _write_annotations(dir_ann):
    for sd in mock.all_sd_tokens():
        anns = [mock.pifpaf_annotation(b) for b in mock.boxes_for(sd)
                if b.name.startswith('human')]
        with open(os.path.join(dir_ann, mock.image_name(sd) + '.predictions.json'), 'w') as f:
            json.dump(anns, f)


def test_preprocess_nuscenes_writes_the_jax_files(tmp_path, monkeypatch):
    """Through `run prep --dataset nuscenes` and the real `factory`, on the
    mock devkit."""
    dir_ann, dir_nu = tmp_path / 'ann', tmp_path / 'nuscenes'
    dir_ann.mkdir()
    dir_nu.mkdir()
    _write_annotations(str(dir_ann))
    monkeypatch.chdir(tmp_path)
    added = mock.install()
    try:
        ours = run.main(['prep', '--dataset', 'nuscenes', '--dir_ann', str(dir_ann),
                         '--dir_nuscenes', str(dir_nu)])
        joints, names = _read_and_remove(ours.path_joints, ours.path_names)
        theirs = jax_nu.PreprocessNuscenes(str(dir_ann), str(dir_nu), 'nuscenes', 0.3)
        theirs.run()
        j_joints, j_names = _read_and_remove(theirs.path_joints, theirs.path_names)
    finally:
        mock.uninstall(added)
    assert len(joints['train']['X']) > 0 and len(joints['val']['X']) > 0
    assert joints == j_joints
    assert names == j_names


def test_nuscenes_teaser_split_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs('splits')
    with open('splits/nuscenes_teaser_scenes.txt', 'w') as f:
        f.write('tok1\ntok2\n')
    with open('splits/split_nuscenes_teaser.json', 'w') as f:
        json.dump({'train': ['tok1'], 'val': ['tok2']}, f)
    added = mock.install()
    try:
        ours = nu.factory('nuscenes_teaser', str(tmp_path))
        theirs = jax_nu.factory('nuscenes_teaser', str(tmp_path))
    finally:
        mock.uninstall(added)
    assert ours[1:] == theirs[1:]
    assert ours[2] == ['scene-0001'] and ours[3] == ['scene-0002']
