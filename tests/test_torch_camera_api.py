"""The camera and preprocess helpers of the port against the JAX package's.

- `project_points` and `xyz_from_distance` on tensors: within 1e-6 of the
  largest output (relative; JAX pins HIGHEST on the 3x3 product, the port
  keeps TF32 off), on `tests/test_geometry.py`'s inputs and seeded ones, in
  each shape rule of the JAX functions.
- `transform_kp`: every mode equal, 'random' too, and the global numpy RNG
  untouched by the port's call; the unimplemented modes raise as in JAX.
- `open_image` on the PNG fixtures: bit for bit with `np.asarray` of the
  JAX package's Pillow image.
- `image_transform` bit for bit; `preprocess_mask` on a written mask tree
  (left, right, an empty-list file, a missing file) equal to JAX.
- `to_cartesian`'s list variant, and the `utils` re-exports of the
  reference's `monoloco.utils` geometry names.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from monoloco_tpu import geometry as jax_geometry
from monoloco_tpu.network import preprocess as jax_preprocess
from monoloco_tpu_torch import geometry, utils
from monoloco_tpu_torch.geometry import camera
from monoloco_tpu_torch.network import preprocess

HERE = os.path.dirname(os.path.abspath(__file__))
KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]
REL = 1e-6


def _close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=REL * np.abs(theirs).max())


def _points(seed, shape):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-10, 10, shape + (3,))
    xyz[..., 1] = rng.uniform(-2, 2, shape)
    xyz[..., 2] = rng.uniform(2, 60, shape)
    return xyz.astype(np.float32)


@pytest.mark.parametrize('case', ['geometry_test', 'rows', 'batched'])
def test_project_points_matches_jax(case):
    xyz = {'geometry_test': np.array([[1.5, -0.5, 12.0]]), 'rows': _points(0, (257,)),
           'batched': _points(1, (4, 17))}[case]
    ours = camera.project_points(torch.as_tensor(xyz), KK)
    _close(ours, jax_geometry.project_points(xyz, KK))
    back = camera.pixel_to_camera(ours, KK, torch.as_tensor(xyz[..., 2:3]))
    np.testing.assert_allclose(back[..., 0:2], xyz[..., 0:2], atol=1e-3)


def _intrinsics(seed, n):
    """n seeded pinhole K's: focal 300-1500 px (fx != fy), principal point
    anywhere in a 1600 x 1000 image, a small skew on half of them."""
    rng = np.random.default_rng(seed)
    kk = np.zeros((n, 3, 3), np.float32)
    kk[:, 0, 0], kk[:, 1, 1] = rng.uniform(300, 1500, n), rng.uniform(300, 1500, n)
    kk[:, 0, 2], kk[:, 1, 2] = rng.uniform(0, 1600, n), rng.uniform(0, 1000, n)
    kk[::2, 0, 1] = rng.uniform(-2, 2, (n + 1) // 2)
    kk[:, 2, 2] = 1.0
    return kk


@pytest.mark.parametrize('batch', [(), (64,), (8, 1)])
def test_pixel_to_camera_inverts_k_as_linalg_inv_bit_for_bit(batch):
    """`pixel_to_camera` takes K^-1 from `torch.linalg.inv_ex` (no info
    check, so no sync with a card): bit for bit `torch.linalg.inv`'s, and the
    back-projection is the one through `linalg.inv`."""
    kk = torch.from_numpy(_intrinsics(len(batch) or 1, max(1, int(np.prod(batch))))
                          .reshape(batch + (3, 3)))
    np.testing.assert_array_equal(torch.linalg.inv_ex(kk).inverse.numpy(),
                                  torch.linalg.inv(kk).numpy())
    uv = torch.from_numpy(np.random.default_rng(9).uniform(0, 1600, batch + (17, 2))
                          .astype(np.float32))
    through_inv = torch.matmul(torch.cat([uv, torch.ones(batch + (17, 1))], dim=-1),
                               torch.linalg.inv(kk).transpose(-1, -2)) * 10
    np.testing.assert_array_equal(camera.pixel_to_camera(uv, kk, 10).numpy(),
                                  through_inv.numpy())


def test_pixel_to_camera_with_a_singular_k_is_non_finite_as_jax():
    """A singular K raises nothing: the back-projection is non-finite, as
    through the JAX package's `jnp.linalg.inv`."""
    kk = np.array([[700., 1400., 600.], [350., 700., 180.], [0., 0., 1.]], np.float32)
    uv = np.array([[600., 180.], [100., 50.]], np.float32)
    ours = camera.pixel_to_camera(torch.from_numpy(uv), torch.from_numpy(kk), 10).numpy()
    theirs = np.asarray(jax_geometry.pixel_to_camera(uv, kk, 10))
    assert not np.isfinite(ours).all() and not np.isfinite(theirs).all()


def _centers(seed, m):
    rng = np.random.default_rng(seed)
    uv = rng.random((m, 2)) * 800
    return jax_geometry.pixel_to_camera(uv, KK, 1.0), rng.random(m) * 40 + 3


@pytest.mark.parametrize('case', ['scalar', 'rows', 'column', 'one_ray'])
def test_xyz_from_distance_matches_jax(case):
    if case == 'scalar':       # tests/test_geometry.py:63
        d, c = 10.0, np.array([[0.3, 0.4, 1.0]])
    elif case == 'one_ray':
        d, c = 12.5, np.array([0.1, -0.2, 1.0])
    else:                      # tests/test_geometry.py:258
        c, d = _centers(2, 7 if case == 'rows' else 33)
        c = np.array(c)
        if case == 'column':
            d = d[:, None]
    ours = camera.xyz_from_distance(torch.as_tensor(d) if case != 'scalar' else d,
                                    torch.as_tensor(c))
    _close(ours, jax_geometry.xyz_from_distance(d, c))
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=1),
                               np.broadcast_to(np.ravel(d), (ours.shape[0],)), rtol=1e-6)


def test_xyz_from_distance_follows_the_tensor_argument():
    d = torch.tensor([4.0, 8.0])
    out = camera.xyz_from_distance(d, [[0.0, 0.0, 1.0], [0.5, 0.0, 1.0]])
    assert out.device == d.device and out.dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), [0.0, 0.0, 4.0])


def _pose(seed=0):
    rng = np.random.RandomState(seed)
    xs = (600 + rng.uniform(-30, 30, 17)).tolist()
    ys = (200 + rng.uniform(-80, 80, 17)).tolist()
    return [xs, ys, [0.9] * 17]


@pytest.mark.parametrize('mode', ['None', 'singularity', 'vertical', 'horizontal', 'shoulder',
                                  'knee', 'up', 'falling', 'random'])
def test_transform_kp_matches_jax(mode):
    kps = _pose(3)
    state = np.random.get_state()
    ours = camera.transform_kp(kps, mode)
    after = np.random.get_state()
    assert after[0] == state[0] and np.array_equal(after[1], state[1]) and after[2:] == state[2:]
    theirs = jax_geometry.transform_kp(kps, mode)
    assert ours == theirs
    if mode == 'None':
        assert ours is kps
    else:
        assert len(ours) == 4 and ours[2] is kps[2] and ours[3] == []


def test_transform_kp_refuses_as_jax():
    for mode in ('upper', 'lower', 'lateral', 'upside'):
        with pytest.raises(NotImplementedError):
            camera.transform_kp(_pose(), mode)
    with pytest.raises(AssertionError):
        camera.transform_kp(_pose(), 'bogus')


@pytest.mark.parametrize('name', ['fixture_002282.png', 'fixture_000840.png'])
def test_open_image_matches_jax(name):
    path = os.path.join(HERE, name)
    ours = camera.open_image(path)
    theirs = np.asarray(jax_geometry.open_image(path))
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape and ours.shape[2] == 3
    np.testing.assert_array_equal(ours, theirs)


def test_open_image_reads_other_formats_through_pillow(monkeypatch):
    path = os.path.join(HERE, 'fixture_frame0032.jpg')
    np.testing.assert_array_equal(camera.open_image(path),
                                  np.asarray(jax_geometry.open_image(path)))
    monkeypatch.setitem(sys.modules, 'PIL', None)        # a machine without Pillow
    with pytest.raises(ImportError, match='Pillow'):
        camera.open_image(path)
    assert camera.open_image(os.path.join(HERE, 'fixture_000840.png')).shape[2] == 3


@pytest.mark.parametrize('source', ['pillow', 'array', 'fixture'])
def test_image_transform_matches_jax(source):
    if source == 'fixture':
        image = Image.open(os.path.join(HERE, 'fixture_000840.png')).convert('RGB')
    else:
        arr = np.random.default_rng(5).integers(0, 256, (9, 13, 3), dtype=np.uint8)
        image = Image.fromarray(arr) if source == 'pillow' else arr
    ours = preprocess.image_transform(image)
    theirs = jax_preprocess.image_transform(image)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(preprocess.image_transform(np.asarray(image)), theirs)


def _mask_tree(tmp_path):
    rng = np.random.default_rng(11)

    def dic(n):
        return {'boxes': rng.uniform(0, 500, (n, 5)).round(3).tolist(),
                'keypoints': rng.uniform(0, 600, (n, 17, 3)).round(3).tolist()}

    dir_ann = tmp_path / 'annotations'
    for sub in ('annotations', 'mask', 'mask_right'):
        (tmp_path / sub).mkdir()
    for sub, name, content in (('mask', '000001', dic(3)), ('mask_right', '000001', dic(2)),
                               ('mask', '000002', []), ('mask_right', '000002', dic(1))):
        with open(tmp_path / sub / f'{name}.json', 'w') as f:
            json.dump(content, f)
    return str(dir_ann)


@pytest.mark.parametrize('basename', ['000001', '000002', '000003'],
                         ids=['poses', 'empty_list', 'missing'])
@pytest.mark.parametrize('mode', ['left', 'right'])
def test_preprocess_mask_matches_jax(tmp_path, basename, mode):
    dir_ann = _mask_tree(tmp_path)
    ours = preprocess.preprocess_mask(dir_ann, basename, mode=mode)
    theirs = jax_preprocess.preprocess_mask(dir_ann, basename, mode=mode)
    assert ours == theirs
    boxes, keypoints = ours
    if basename == '000001':
        assert len(boxes) == (3 if mode == 'left' else 2)
        assert all(len(k) == 3 and len(k[0]) == 17 for k in keypoints)
    elif (basename, mode) == ('000002', 'right'):
        assert len(boxes) == len(keypoints) == 1
    else:
        assert ours == ([], [])


def test_to_cartesian_list_variant_matches_jax():
    rtp = [21.5, 1.2, 1.45]
    assert camera.to_cartesian(rtp) == jax_geometry.to_cartesian(rtp)
    assert camera.to_cartesian(camera.to_spherical([3.0, -1.0, 20.0])) == pytest.approx(
        [3.0, -1.0, 20.0])


def test_utils_reexports_the_reference_geometry_names():
    from monoloco_tpu import utils as jax_utils
    for name in utils._GEOMETRY:
        assert hasattr(jax_utils, name), name
        assert getattr(utils, name) is getattr(geometry, name), name
    with pytest.raises(AttributeError):
        utils.no_such_name
