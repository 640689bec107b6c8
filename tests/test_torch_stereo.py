"""The port's stereo (MonStereo) slice against the JAX package on the CPU.

Inputs are keypoints from a numpy seed or the fixture's pifpaf poses with a
right image made by shifting each pose left by a disparity BF / z; weights
are the JAX package's `init_loco_params` arrays, carried across as numpy.
Tolerances:
 - host numpy copies (`geometry/stereo.py`): bit for bit;
 - the pairing (`preprocess_monstereo`): 1e-6, two f32 back-projections;
 - the per-image and batched stereo forward: d, bi and aux within 1e-5, xyzd
   within 1e-4 (two f32 frameworks, two sum orders; decode's sqrt grows the
   MLP's 1e-6), the chosen right pose (`aux_idx`) equal;
 - predict --mode stereo against `monoloco_tpu.predict`: 1e-4, confs 1e-3
   (the byte-compat rules), host fields exactly.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu import predict as jax_predict
from monoloco_tpu import run as jax_run
from monoloco_tpu.geometry import stereo as jax_stereo
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.models import init_monoloco_params as jax_init_monoloco
from monoloco_tpu.models import save_checkpoint as jax_save
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu.network import engine as jax_engine
from monoloco_tpu.network.decode import cluster_outputs as jax_cluster
from monoloco_tpu.network.decode import filter_outputs as jax_filter
from monoloco_tpu.network.preprocess import preprocess_monstereo as jax_pair
from monoloco_tpu.ops import quant as jax_quant
from monoloco_tpu_torch import run
from monoloco_tpu_torch.geometry import stereo
from monoloco_tpu_torch.network import (Loco, cluster_outputs, engine, filter_outputs,
                                        median_disparity, preprocess_monstereo)
from monoloco_tpu_torch.ops import dyn8_forward_plain
from monoloco_tpu_torch.ops.quant import synthetic_calibration_inputs
from monoloco_tpu_torch.utils import serving_precision, trace

import torch_stereo_grid as grid

HERE = os.path.dirname(os.path.abspath(__file__))
KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]
KK2 = [[700., 0., 590.], [0., 700., 170.], [0., 0., 1.]]
TOL = 1e-5
EXACT = ('gt', 'indices', 'boxes', 'uv_kps', 'uv_centers', 'uv_shoulders', 'uv_heads')


def _keypoints(m, seed=0):
    rng = np.random.RandomState(seed)
    kps = rng.rand(m, 3, 17).astype(np.float32)
    kps[:, 0] = kps[:, 0] * 800 + 200
    kps[:, 1] = kps[:, 1] * 200 + 80
    kps[:, 2] = 0.8
    return kps


def _right_of(kps, seed, noise=1.0):
    """A right view of left poses: each shifted left by BF / z, z in 5-40 m,
    with pixel noise; confidences drawn so that some joints fall out."""
    rng = np.random.RandomState(seed)
    right = kps.copy()
    right[:, 0] -= (stereo.BF / rng.uniform(5, 40, size=len(kps)))[:, None]
    right[:, 0:2] += rng.normal(0, noise, size=right[:, 0:2].shape)
    right[:, 2] = rng.uniform(0.1, 1.0, size=right[:, 2].shape)
    return right.astype(np.float32)


def _jax_tree(key, in_dim, out_dim, hidden, n_stage, init=jax_init, ahead=False):
    """JAX init arrays as numpy. With `ahead`, the output biases put people
    ahead of the camera, as a trained net does: theta and psi at pi/2, the
    distance at 15 m. Otherwise random weights predict z near 0, where the
    egocentric yaw's atan2(x, z) magnifies the last ulp of x."""
    params, bn = init(key, in_dim, out_dim, hidden, n_stage)
    params, bn = jax.tree_util.tree_map(np.array, params), jax.tree_util.tree_map(np.array, bn)
    if ahead:
        params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    return params, bn


@pytest.fixture(scope='module', params=[64, 128])
def nets(request):
    """(port, JAX) stereo engines on one set of weights, hidden 64 or 128,
    2 stages."""
    model = _jax_tree(jax.random.PRNGKey(1), 68, 10, request.param, 2)
    return (Loco(model, mode='stereo', device='cpu'),
            JaxLoco(model, mode='stereo', linear_size=request.param, n_stage=2))


def _assert_stereo_close(ours, ref):
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for key in ('d', 'bi', 'aux', 'h', 'w', 'l', 'ori'):
        np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(ours['xyzd'], np.asarray(ref['xyzd']), rtol=1e-4, atol=1e-4)
    # The allocentric yaw only: the egocentric one adds atan2(x, z), which
    # random weights put near z = 0, where it magnifies the last ulp.
    np.testing.assert_allclose(ours['yaw'][0], np.asarray(ref['yaw'][0]), rtol=1e-4, atol=1e-4)
    if 'aux_idx' in ref:
        np.testing.assert_array_equal(ours['aux_idx'], np.asarray(ref['aux_idx']))


# --- host copies: bit for bit ---------------------------------------------

@pytest.mark.parametrize('m,r,conf_min', [(1, 1, 0.3), (4, 6, 0.3), (7, 3, 0.5)])
def test_mask_joint_disparity_is_jax_bit_for_bit(m, r, conf_min):
    kps = _keypoints(m, seed=m)
    kps[:, 2] = np.random.RandomState(m + 1).uniform(0, 1, size=(m, 17))
    kps_r = _right_of(_keypoints(r, seed=r + 10), seed=r)
    for ours, ref in zip(stereo.mask_joint_disparity(kps, kps_r, conf_min),
                         jax_stereo.mask_joint_disparity(kps, kps_r, conf_min)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('r', [1, 5])
def test_average_locations_is_jax_bit_for_bit(r):
    kps = _keypoints(1, seed=3)
    kps_r = _right_of(np.repeat(kps, r, axis=0), seed=4)
    for ours, ref in zip(stereo.average_locations(kps, kps_r),
                         jax_stereo.average_locations(kps, kps_r)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('phase,method', [('train', None), ('val', None), ('train', 'mask')])
def test_extract_stereo_matches_is_jax(phase, method):
    kps = _keypoints(6, seed=21)
    kps_r = _right_of(kps, seed=22, noise=3.0)
    for i in range(len(kps)):
        for zz in (6.0, 18.0, 45.0):
            ours = stereo.extract_stereo_matches(kps[i:i + 1], kps_r, zz, phase, seed=i,
                                                 method=method)
            ref = jax_stereo.extract_stereo_matches(kps[i:i + 1], kps_r, zz, phase, seed=i,
                                                    method=method)
            assert ours == ref


def test_disparity_helpers_are_jax():
    for zz in (2.0, 10.0, 55.0):
        assert stereo.depth_to_pixel_error(zz, 1.5) == jax_stereo.depth_to_pixel_error(zz, 1.5)
    for disp in (0.0, np.nan, 12.5):
        ours, ref = stereo.disparity_to_depth(disp), jax_stereo.disparity_to_depth(disp)
        assert ours[1] == ref[1] and (ours[0] == ref[0] or (np.isnan(ours[0]) and np.isnan(ref[0])))
    assert stereo.BF == jax_stereo.BF and stereo.D_MAX == jax_stereo.D_MAX


# --- the pairing and the decode ----------------------------------------------

@pytest.mark.parametrize('m,r', [(1, 1), (3, 5), (8, 2)])
def test_preprocess_monstereo_matches_jax(m, r):
    kps, kps_r = _keypoints(m, seed=m), _keypoints(r, seed=r + 50)
    ours, clusters = preprocess_monstereo(torch.from_numpy(kps), torch.from_numpy(kps_r),
                                          torch.tensor(KK))
    ref, ref_clusters = jax_pair(kps, kps_r, np.asarray(KK, np.float32))
    assert clusters == ref_clusters == [r] * m
    assert ours.shape == (m * r, 68)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_batched_pairing_is_per_image_pairing():
    """A leading image axis pairs each image's own poses (the JAX vmap)."""
    kps = np.stack([_keypoints(4, seed=s) for s in (1, 2)])
    kps_r = np.stack([_keypoints(3, seed=s) for s in (3, 4)])
    kks = torch.tensor([KK, KK2])
    batched, _ = preprocess_monstereo(torch.from_numpy(kps), torch.from_numpy(kps_r), kks)
    for i in range(2):
        single, _ = preprocess_monstereo(torch.from_numpy(kps[i]), torch.from_numpy(kps_r[i]),
                                         kks[i])
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(), rtol=1e-6, atol=1e-6)


def test_synthetic_calibration_inputs_68_matches_jax():
    ours = synthetic_calibration_inputs(68, n=300)
    ref = np.asarray(jax_quant.synthetic_calibration_inputs(68, n=300))
    assert ours.shape == ref.shape == (17 * 17, 68)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('clusters', [0, 3])
def test_cluster_and_filter_outputs_equal_jax(clusters):
    rng = np.random.default_rng(clusters)
    outputs = rng.normal(size=(12, 10)).astype(np.float32)
    outputs[4, -1] = outputs[5, -1] = 9.0      # a tie: the first maximum wins
    ours = cluster_outputs(torch.from_numpy(outputs), clusters)
    ref = np.asarray(jax_cluster(outputs, clusters))
    np.testing.assert_array_equal(ours.numpy(), ref)
    selected, mask = filter_outputs(ours)
    ref_selected, ref_mask = jax_filter(ref)
    np.testing.assert_array_equal(selected.numpy(), np.asarray(ref_selected))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


# --- the engine ------------------------------------------------------------

@pytest.mark.parametrize('r', [0, 1, 3, 5])
@pytest.mark.parametrize('m', [1, 4, 7])
def test_stereo_forward_matches_jax(nets, m, r):
    """Per image; r = 0 passes no right poses (the first left pose stands
    in). One dispatch an image."""
    net, jnet = nets
    kps = _keypoints(m, seed=m)
    kps_r = None if r == 0 else _right_of(_keypoints(r, seed=r + 30), seed=r)
    before = net.n_dispatches
    ours = net.forward(kps, KK, keypoints_r=kps_r)
    assert net.n_dispatches == before + 1
    ref = jnet.forward(kps, KK, keypoints_r=kps_r)
    assert ours['aux_idx'].shape == (m,) and ours['d'].shape == (m, 1)
    _assert_stereo_close(ours, ref)


def test_forward_batch_matches_jax_on_a_mixed_batch(nets):
    """One image without right poses and one without any poses, as the JAX
    engine's own test (tests/test_engine.py) mixes them; each image's right
    pose choice (`aux_idx`) is the per-image forward's."""
    net, jnet = nets
    kps = [_keypoints(3, seed=1), _keypoints(6, seed=2), np.zeros((0, 3, 17), np.float32),
           _keypoints(2, seed=3)]
    kps_r = [_keypoints(4, seed=4), None, _keypoints(2, seed=6), _keypoints(2, seed=5)]
    kks = [KK, KK2, KK, KK]
    outs = net.forward_batch(kps, kks, kps_r)
    refs = jnet.forward_batch(kps, kks, kps_r)
    assert outs[2] is None and refs[2] is None
    for ours, ref, k, kk, k_r in zip(outs, refs, kps, kks, kps_r):
        if ref is not None:
            alone = net.forward(k, kk, keypoints_r=k_r)
            np.testing.assert_array_equal(ours.pop('aux_idx'), alone['aux_idx'])
            _assert_stereo_close(ours, ref)


def test_stereo_padding_invariance(nets):
    """An image alone (m bucket 4, r bucket 4) and beside a crowd (m bucket
    8, r bucket 8) gives the same result, and the batch matches the
    per-image forward with its chosen pairing."""
    net, _ = nets
    kps, kps_r = _keypoints(3, seed=11), _right_of(_keypoints(3, seed=11), seed=12)
    alone = net.forward(kps, KK, keypoints_r=kps_r)
    batch = net.forward_batch([kps, _keypoints(7, seed=13)], [KK, KK2],
                              [kps_r, _keypoints(6, seed=14)])
    assert net.n_dispatches >= 2
    for key in ('d', 'bi', 'aux', 'xyzd'):
        np.testing.assert_allclose(batch[0][key], alone[key], rtol=TOL, atol=TOL, err_msg=key)
    empty = net.forward_batch_async([], [], [])
    assert empty() == []


def test_stereo_batch_counts_padded_pairs(monkeypatch):
    """The dispatch counts at its flat pairs rounded up to the 128-row tile
    (L x R a frame, L x 1 where the first left pose stands in), not at the
    padded b x m x r grid, and an int8 engine routes to dyn8 there (the
    plain version on the CPU)."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    monkeypatch.setattr(engine, '_INT8_MIN_ROWS', 129)
    net = Loco(_jax_tree(jax.random.PRNGKey(5), 68, 10, 128, 2), mode='stereo', device='cpu')
    kps = [_keypoints(12, seed=s) for s in range(3)]
    # 12 x 5 + 12 x 1 + 12 x 5 = 132 pairs: 256 rows (120 without the stand-in: 128).
    net.forward_batch(kps, [KK] * 3, [_keypoints(5, seed=9), None, _keypoints(5, seed=8)])
    assert (net.n_dispatches, net.n_dispatches_int8) == (1, 1)
    net.forward(kps[0], KK, keypoints_r=_keypoints(5, seed=9))      # 60 pairs: 128 rows
    assert (net.n_dispatches, net.n_dispatches_int8) == (2, 1)


def test_int8_stereo_routes_to_the_plain_dyn8_version(monkeypatch):
    """Under int8 with the floor lowered, the stereo dispatch runs the dyn8
    route on the m x r pairing (its plain version on the CPU): the selected
    rows are dyn8_forward_plain's rows of the pairing, bit for bit, and the
    choice of the right pose follows their aux logits."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    monkeypatch.setattr(engine, '_INT8_MIN_ROWS', 16)
    model = _jax_tree(jax.random.PRNGKey(6), 68, 10, 128, 2)
    net = Loco(model, mode='stereo', device='cpu')
    assert net.precision == 'int8' and net.mlp_weights['packed_int8'] is not None
    kps, kps_r = _keypoints(4, seed=1), _right_of(_keypoints(3, seed=2), seed=3)
    out = net.forward(kps, KK, keypoints_r=kps_r)
    assert (net.n_dispatches, net.n_dispatches_int8) == (1, 1)       # 4 x 4 = 16 rows
    pad_r = np.concatenate([kps_r, np.zeros((1, 3, 17), np.float32)])
    inputs, _ = preprocess_monstereo(torch.from_numpy(kps), torch.from_numpy(pad_r),
                                     torch.tensor(KK))
    raw = dyn8_forward_plain(net.mlp_weights['packed_int8'], inputs).reshape(4, 4, 10)
    best = torch.argmax(raw[:, :3, -1], dim=1)
    np.testing.assert_array_equal(out['aux_idx'], best.numpy())
    np.testing.assert_array_equal(out['aux'][:, 0],
                                  torch.sigmoid(raw[torch.arange(4), best, -1]).numpy())
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'float32')
    ref = Loco(model, mode='stereo', device='cpu').forward(kps, KK, keypoints_r=kps_r)
    assert not np.array_equal(out['d'], ref['d'])
    np.testing.assert_allclose(out['d'], ref['d'], rtol=0.05, atol=0.05)


# --- the flat stereo dispatch ---------------------------------------------

def _tile_rows(n_pairs):
    return max(128, -(-n_pairs // 128) * 128)


@pytest.mark.parametrize('mix', list(grid.MIXES))
def test_flat_stereo_dispatch_matches_jax_and_the_padded_grid(nets, mix):
    """The batched stereo dispatch runs each frame's real L x R pairs only,
    packed flat: every real left pose's outputs and `aux_idx` match the JAX
    engine (its padded m x r program) and the padded-grid evaluation of the
    same batch (`torch_stereo_grid.padded_grid`); of two equal right poses
    the first wins; the MLP runs sum L x R rows rounded up to the 128-row
    tile, with no blocking copy."""
    net, jnet = nets
    left, kks, right = grid.frames(grid.MIXES[mix], seed=len(mix))
    trace.reset()
    trace.enable()
    try:
        outs = net.forward_batch(left, kks, right)
    finally:
        trace.disable()
    recs = {r['name']: r['attrs'] for r in trace.records()}
    trace.reset()
    grid.assert_same(outs, grid.padded_grid(net, left, kks, right), exact=False, tol=TOL)
    refs = jnet.forward_batch(left, kks, right)
    for ours, ref, k, kk, k_r in zip(outs, refs, left, kks, right):
        assert (ours is None) == (ref is None)
        if ref is not None:
            # The JAX batch returns no aux_idx; its per-image forward does.
            ours = dict(ours)
            ref_idx = jnet.forward(k, kk, keypoints_r=k_r)['aux_idx']
            np.testing.assert_array_equal(ours.pop('aux_idx'), np.asarray(ref_idx))
            _assert_stereo_close(ours, ref)
    if mix == 'tie':
        np.testing.assert_array_equal(outs[0]['aux_idx'], 0)
    useful = sum(len(k) * (0 if r is None else len(r)) for k, r in zip(left, right))
    assert recs['loco.dispatch'] == {'rows_useful': useful,
                                     'rows_run': _tile_rows(grid.n_pairs(left, right)),
                                     'h2d_copies': 0}
    assert recs['loco.finalize'] == {'d2h_copies': 0}


@pytest.mark.parametrize('precision', ['int8', 'bfloat16'])
def test_flat_stereo_dispatch_on_the_plain_kernels_is_the_padded_grid(monkeypatch, precision):
    """Under int8 (dyn8) and bfloat16 (K1-bf16), their plain versions on the
    CPU, the flat dispatch matches the padded-grid evaluation on every mix
    and a crowd chunk, and every dispatch keeps its route."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
    net = Loco(_jax_tree(jax.random.PRNGKey(7), 68, 10, 128, 2, ahead=True), mode='stereo',
               device='cpu')
    batches = [grid.frames(spec, seed=i) for i, spec in enumerate(grid.MIXES.values())]
    for args in batches + [grid.crowd(16, seed=3)]:
        grid.assert_same(net.forward_batch(*args), grid.padded_grid(net, *args), exact=False,
                         tol=TOL)
    assert net.n_dispatches_int8 == (net.n_dispatches if precision == 'int8' else 0)


def test_median_disparity_matches_jax():
    rng = np.random.RandomState(7)
    kps = _keypoints(5, seed=7)
    kps_r = _right_of(kps[::-1].copy(), seed=8)
    dic = {'xyzd': rng.uniform(1, 30, size=(5, 4)).astype(np.float32),
           'aux': np.array([0.9, 0.2, 0.7, 0.51, 0.6], np.float32)[:, None],
           'aux_idx': np.array([4, 0, 2, 1, 0])}
    ours = median_disparity(dict(dic), kps, kps_r)
    ref = jax_engine.median_disparity(dict(dic), kps, kps_r)
    np.testing.assert_array_equal(ours['xyzd'], ref['xyzd'])
    assert not np.array_equal(ours['xyzd'], dic['xyzd'])
    mask = np.eye(5, dtype=bool)[::-1]
    np.testing.assert_array_equal(median_disparity(dict(dic), kps, kps_r, mask)['xyzd'],
                                  jax_engine.median_disparity(dict(dic), kps, kps_r,
                                                              mask)['xyzd'])


# --- the constructor and the precision knob ------------------------------------

@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp('ckpt')
    paths = {}
    for name, tree in (('mono', _jax_tree(jax.random.PRNGKey(0), 34, 9, 128, 3)),
                       ('stereo', _jax_tree(jax.random.PRNGKey(1), 68, 10, 128, 2,
                                            ahead=True)),
                       ('monoloco', _jax_tree(jax.random.PRNGKey(2), 34, 2, 64, 3,
                                              init=jax_init_monoloco))):
        paths[name] = str(root / f'{name}.pkl')
        jax_save(paths[name], *tree)
    return paths


# The keyword sets of the JAX package's callers of Loco.
CALLERS = {
    'predict.py:168': ('mono', dict(mode='mono', net=None, n_dropout=0, p_dropout=0.2)),
    'predict.py:168 stereo': ('stereo', dict(mode='stereo', net=None, n_dropout=0,
                                             p_dropout=0.3)),
    'generate_kitti.py:41': ('stereo', dict(mode='stereo', n_dropout=0, p_dropout=0.2,
                                            linear_size=1024, n_stage=3, mesh=None)),
    'generate_kitti.py:53': ('monoloco', dict(mode='mono', net='monoloco', n_dropout=0,
                                              p_dropout=0.2, linear_size=256)),
    'eval_activity.py:62': ('mono', dict(mode='mono', n_dropout=0, p_dropout=0.2)),
    'make_reference_goldens.py:152': ('mono', dict(mode='mono', linear_size=1024,
                                                   n_dropout=0)),
}


@pytest.mark.parametrize('caller', list(CALLERS))
def test_loco_takes_the_jax_callers_keywords(monkeypatch, checkpoints, caller):
    """Each call exactly as the JAX caller makes it (no device: the engine's
    default device, the CPU here). linear_size and n_stage are hints the
    checkpoint overrides, p_dropout is kept for MC dropout."""
    monkeypatch.setattr(engine, 'default_device', lambda: torch.device('cpu'))
    ckpt, kwargs = CALLERS[caller]
    net = Loco(model=checkpoints[ckpt], **kwargs)
    jnet = JaxLoco(model=checkpoints[ckpt], **kwargs)
    assert (net.net, net.mode, net.p_dropout) == (jnet.net, jnet.mode, jnet.p_dropout)
    assert (net.linear_size, net.n_stage) == (jnet.linear_size, jnet.n_stage)
    kps = _keypoints(3, seed=1)
    ours, ref = net.forward(kps, KK), jnet.forward(kps, KK)
    np.testing.assert_allclose(ours['d'], np.asarray(ref['d']), rtol=TOL, atol=TOL)


def test_loco_still_refuses_mc_dropout_and_meshes():
    """The name is kept from when meshes were refused: unknown modes are
    refused; a mesh computes what no mesh computes (here one rank, gloo, in
    this process; tests/test_torch_parallel.py holds two). MC dropout is
    served since it was ported: on the stereo net it leaves epi at zeros,
    as the JAX engine does (`engine.py:404`)."""
    model = _jax_tree(jax.random.PRNGKey(1), 68, 10, 64, 2)
    net = Loco(model, mode='stereo', n_dropout=2, device='cpu')
    kps = _keypoints(3, seed=1)
    assert list(net.forward(kps, KK, keypoints_r=kps)['epi']) == [0.0] * 3
    assert net.forward_batch([kps], [KK], [kps])[0]['epi'] == [0.0] * 3
    from monoloco_tpu_torch.parallel import launch

    def on_mesh(mesh):
        return Loco(model, mode='stereo', mesh=mesh).forward_batch([kps], [KK], [kps])[0]

    ours = launch(on_mesh, 1, device_type='cpu', timeout=60)
    ref = Loco(model, mode='stereo', device='cpu').forward_batch([kps], [KK], [kps])[0]
    assert np.array_equal(ours['xyzd'], ref['xyzd'])
    assert np.array_equal(ours['aux_idx'], ref['aux_idx'])
    with pytest.raises(ValueError, match='mode'):
        Loco(model, mode='keypoints', device='cpu')


@pytest.mark.parametrize('raw,canon', [('fp32', 'float32'), ('highest', 'float32'),
                                       ('int8-a8', 'default'), ('int8-xla', 'default')])
def test_jax_precision_spellings_are_served(monkeypatch, raw, canon):
    """As in the JAX engine, which serves its default path under int8-a8 and
    int8-xla: no int8 pack."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', raw)
    assert serving_precision() == canon
    net = Loco(_jax_tree(jax.random.PRNGKey(1), 68, 10, 128, 2), mode='stereo', device='cpu')
    assert net.precision == canon and net.mlp_weights['packed_int8'] is None


@pytest.mark.parametrize('raw', ['bf16', 'bfloat16', 'tensorfloat32'])
def test_bf16_spellings_wait_for_serving(monkeypatch, raw):
    """The three spellings are served: under bf16/bfloat16 the stereo net
    (hidden 128) routes its pairing rows to K1-bf16 (its plain version on
    the CPU), within the 0.02 budget of the f32 engine on the distance;
    tensorfloat32 has no kernel and equals f32 on the CPU."""
    model = _jax_tree(jax.random.PRNGKey(1), 68, 10, 128, 2)
    kps, kps_r = _keypoints(4, seed=3), _keypoints(3, seed=4)
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'float32')
    ref = Loco(model, mode='stereo', device='cpu').forward(kps, KK, keypoints_r=kps_r)
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', raw)
    canon = 'tensorfloat32' if raw == 'tensorfloat32' else 'bfloat16'
    assert serving_precision() == canon
    net = Loco(model, mode='stereo', device='cpu')
    assert (net.mlp_weights['packed_bf16'] is not None) == (canon == 'bfloat16')
    out = net.forward(kps, KK, keypoints_r=kps_r)
    if canon == 'tensorfloat32':
        np.testing.assert_array_equal(out['d'], ref['d'])
    else:
        rel = float(np.abs(out['d'] - ref['d']).mean() / np.abs(ref['d']).mean())
        assert 0 < rel < 0.02, rel


# --- predict --mode stereo against monoloco_tpu.predict ------------------------

def _stereo_images(root, n_pairs):
    """n_pairs (left, right) fixture pairs: pair{i}a.png holds the fixture's
    poses, pair{i}b.png the same poses shifted left by BF / z each."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(HERE, 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    for i in range(n_pairs):
        rng = np.random.RandomState(100 + i)
        right = []
        for ann in anns:
            shift = stereo.BF / rng.uniform(5, 40)
            kps = list(ann['keypoints'])
            kps[0::3] = [x - shift for x in kps[0::3]]
            box = list(ann['bbox'])
            box[0] -= shift
            box[2] -= shift
            right.append({**ann, 'keypoints': kps, 'bbox': box})
        for side, poses in (('a', anns), ('b', right)):
            dst = os.path.join(root, f'pair{i}{side}.png')
            shutil.copy(os.path.join(HERE, 'fixture_002282.png'), dst)
            with open(dst + '.pifpaf.json', 'w') as f:
                json.dump(poses, f)
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith('.png'))


@pytest.mark.parametrize('n_pairs', [1, 3])
def test_predict_stereo_cli_matches_jax(tmp_path, monkeypatch, checkpoints, n_pairs):
    """1 pair takes the per-image loop, 3 the batched chunk path."""
    imgs = _stereo_images(str(tmp_path / 'imgs'), n_pairs)
    common = ['--mode', 'stereo', '--model', checkpoints['stereo'], '--calibration', 'kitti',
              '--output_types', 'json']
    net = run.main(['predict', *imgs[::-1], *common, '-o', str(tmp_path / 'ours'),
                    '--disable-cuda'])
    assert net.net == 'monstereo' and net.p_dropout == 0.2
    assert net.n_dispatches == (1 if n_pairs == 3 else n_pairs)
    monkeypatch.setattr(sys, 'argv', ['monoloco_tpu.run', 'predict', *imgs, *common,
                                      '-o', str(tmp_path / 'ref')])
    jax_predict.predict(jax_run.cli())
    names = sorted(os.listdir(tmp_path / 'ref'))
    assert names == sorted(os.listdir(tmp_path / 'ours'))
    assert names == [f'out_pair{i}a.png.monoloco.json' for i in range(n_pairs)]
    for name in names:
        with open(tmp_path / 'ours' / name) as f:
            ours = json.load(f)
        with open(tmp_path / 'ref' / name) as f:
            ref = json.load(f)
        assert list(ours) == list(ref) and len(ref['aux']) == 16, name
        for key in ref:
            if key in EXACT:
                assert ours[key] == ref[key], (name, key)
            else:
                tol = 1e-3 if key == 'confs' else 1e-4
                np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                           np.asarray(ref[key], np.float64),
                                           rtol=tol, atol=tol, err_msg=f'{name}:{key}')
