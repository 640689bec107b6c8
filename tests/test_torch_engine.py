"""The port's preprocess, decode and mono engine against the JAX package.

Inputs are the fixture's pifpaf keypoints and the byte-compat checkpoint, or
keypoints from a numpy seed. Tolerances: f32 paths agree with JAX to 1e-5
(relative and absolute; both are f32 with different sum orders); against
the reference golden, the byte-compat rules (1e-4, confs 1e-3). The int8
route is compared with the JAX kernel in interpret mode by mean (tight) and
max (loose) error, since a last-ulp difference can flip one quantization tie.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu.network import engine as jax_engine
from monoloco_tpu.network.decode import (extract_outputs as jax_extract,
                                         extract_outputs_mono as jax_extract_mono)
from monoloco_tpu.network.preprocess import (load_calibration as jax_load_calibration,
                                             preprocess_monoloco as jax_preprocess,
                                             preprocess_pifpaf as jax_preprocess_pifpaf)
from monoloco_tpu_torch.models import params_from_numpy
from monoloco_tpu_torch.network import (Loco, extract_outputs, extract_outputs_mono,
                                        load_calibration, preprocess_monoloco,
                                        preprocess_pifpaf)
from monoloco_tpu_torch.network import engine
from monoloco_tpu_torch.utils import serving_precision

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, 'goldens', 'byte_compat')
IM_SIZE = (1238, 374)
TOL = 1e-5


@pytest.fixture(scope='module')
def fixture_dets():
    with open(os.path.join(HERE, 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    return anns


def _flat(dic):
    out = {}
    for k, v in dic.items():
        if k == 'yaw':
            out['yaw_pred'], out['yaw_orig'] = np.asarray(v[0]), np.asarray(v[1])
        elif k != 'epi':
            out[k] = np.asarray(v)
    return out


def _assert_dicts_close(ours, ref, tol=TOL):
    ours, ref = _flat(ours), _flat(ref)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize('preset', ['kitti', 'nuscenes', 'wv', 'custom'])
def test_calibration_presets_match_jax_yaml(preset):
    assert load_calibration(preset, (640, 480)) == jax_load_calibration(preset, (640, 480))


def test_preprocess_and_decode_match_jax_on_fixture(fixture_dets):
    boxes, kps = preprocess_pifpaf(fixture_dets, IM_SIZE, enlarge_boxes=False)
    jboxes, jkps = jax_preprocess_pifpaf(fixture_dets, IM_SIZE, enlarge_boxes=False)
    assert boxes == jboxes and kps == jkps
    kk = load_calibration('kitti', IM_SIZE)
    ours = preprocess_monoloco(torch.tensor(kps), torch.tensor(kk)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_preprocess(np.asarray(kps), kk)),
                               rtol=TOL, atol=TOL)
    # Decode raw outputs shaped like the net's, 9 and 10 channels.
    raw = np.random.default_rng(5).normal(size=(len(kps), 10)).astype(np.float32)
    raw[:, 2] = np.abs(raw[:, 2]) * 20 + 1          # distances
    for width in (9, 10):
        r = raw[:, :width]
        _assert_dicts_close(extract_outputs(torch.from_numpy(r)), jax_extract(r))
    _assert_dicts_close(extract_outputs_mono(torch.from_numpy(raw[:, :9])),
                        jax_extract_mono(raw[:, :9]))


def test_batched_preprocess_matches_per_image():
    rng = np.random.default_rng(6)
    kps = rng.uniform(0, 600, size=(3, 5, 3, 17)).astype(np.float32)
    kks = np.stack([np.array(load_calibration('kitti', (600 + 10 * i, 300)), np.float32)
                    for i in range(3)])
    batched = preprocess_monoloco(torch.from_numpy(kps), torch.from_numpy(kks))
    for i in range(3):
        single = preprocess_monoloco(torch.from_numpy(kps[i]), torch.from_numpy(kks[i]))
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(), rtol=1e-6, atol=1e-6)


def test_forward_and_post_process_match_jax_and_golden(fixture_dets):
    with open(os.path.join(GOLD, 'manifest.json')) as f:
        im_size = tuple(json.load(f)['im_size'])
    kk = [list(row) for row in load_calibration('kitti', im_size)]
    boxes, keypoints = preprocess_pifpaf(fixture_dets, im_size=im_size)
    net = Loco(model=os.path.join(GOLD, 'model_tpu.pkl'), mode='mono', device='cpu')
    jnet = JaxLoco(model=os.path.join(GOLD, 'model_tpu.pkl'), mode='mono')
    dic = net.forward(keypoints, kk)
    jdic = jnet.forward(keypoints, kk)
    _assert_dicts_close(dic, jdic)
    ours = net.post_process(dic, boxes, keypoints, kk)
    theirs = jnet.post_process(jdic, boxes, keypoints, kk)
    assert list(ours.keys()) == list(theirs.keys())
    with open(os.path.join(GOLD, 'out.monoloco.json')) as f:
        ref = json.load(f)
    assert set(ref) <= set(ours) and set(ours) - set(ref) <= {'indices'}
    for key, ref_v in ref.items():
        assert len(ours[key]) == len(ref_v), key
        if key == 'gt':
            assert list(ours[key]) == list(ref_v)
            continue
        a = np.asarray(ours[key], np.float64)
        tol = 1e-3 if key == 'confs' else 1e-4
        np.testing.assert_allclose(a, np.asarray(ref_v, np.float64), rtol=tol, atol=tol,
                                   err_msg=key)
        np.testing.assert_allclose(a, np.asarray(theirs[key], np.float64), rtol=TOL,
                                   atol=TOL, err_msg=key)


def _toy_params(hidden=128):
    params, bn = jax_init(jax.random.PRNGKey(0), 34, 9, hidden, 3)
    return (jax.tree_util.tree_map(np.array, params),
            jax.tree_util.tree_map(np.array, bn))


def _toy_batch(n_img=6, seed=7):
    rng = np.random.default_rng(seed)
    kps = [rng.uniform(0, 400, size=(int(rng.integers(1, 4)), 3, 17)).astype(np.float32)
           for _ in range(n_img)]
    kks = [np.array([[720., 0., 600.], [0., 720., 180.], [0., 0., 1.]], np.float32)] * n_img
    return kps, kks


def test_int8_batch_route_matches_jax_interpret(monkeypatch):
    """MONOLOCO_TPU_PRECISION=int8 with the routing floor lowered in both
    engines: the port's dyn8 route (plain version on the CPU) against the
    JAX engine's Pallas kernel in interpret mode, counters included."""
    monkeypatch.setattr(jax_engine, '_INT8', True)
    monkeypatch.setattr(jax_engine, '_INT8_MIN_ROWS', 8)
    monkeypatch.setattr(engine, '_INT8_MIN_ROWS', 8)
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8')
    params, bn = _toy_params()
    jnet = JaxLoco(model=(params, bn), mode='mono', net='monoloco_pp')
    net = Loco(model=params_from_numpy(params, bn), mode='mono', device='cpu')
    assert net.mlp_weights['packed_int8'] is not None and net.precision == 'int8'
    kps, kks = _toy_batch()
    outs, jouts = net.forward_batch(kps, kks), jnet.forward_batch(kps, kks)
    assert net.n_dispatches == net.n_dispatches_int8 == 1
    assert jnet.n_dispatches == jnet.n_dispatches_int8 == 1
    diffs, refs = [], []
    for o, j, k in zip(outs, jouts, kps):
        assert o['xyzd'].shape == (len(k), 4)
        diffs.append(np.abs(o['xyzd'] - np.asarray(j['xyzd'])))
        refs.append(np.abs(np.asarray(j['xyzd'])))
    # ~50 decoded values: one flipped tie (~1e-3, amplified in z near 0)
    # moves their mean by ~1e-3 of the mean output.
    diffs, refs = np.concatenate(diffs), np.concatenate(refs)
    assert diffs.mean() <= 2e-3 * refs.mean() and diffs.max() <= 1e-2, diffs.max()

    # Under the floor the f32 path runs, in both engines alike.
    one = net.forward(kps[0], kks[0])
    assert net.n_dispatches == 2 and net.n_dispatches_int8 == 1
    f32 = Loco(model=params_from_numpy(params, bn), mode='mono', device='cpu')
    np.testing.assert_array_equal(one['xyzd'], f32.forward(kps[0], kks[0])['xyzd'])


def test_async_batch_matches_per_image_forward():
    params, bn = _toy_params()
    net = Loco(model=params_from_numpy(params, bn), mode='mono', device='cpu')
    kps, kks = _toy_batch(n_img=5, seed=8)
    kps[2] = np.zeros((0, 3, 17), np.float32)          # an image without people
    finalize = net.forward_batch_async(kps, kks)
    outs = finalize()
    assert outs[2] is None and net.n_dispatches == 1
    for i in (0, 1, 3, 4):
        _assert_dicts_close(outs[i], net.forward(kps[i], kks[i]))
    assert net.forward_batch_async([], [])() == []


@pytest.mark.parametrize('net,out_dim', [('monoloco_p', 9), ('monoloco', 2)])
def test_legacy_mono_nets_match_jax(net, out_dim):
    """The legacy MonoLoco nets (single-Linear head, hidden 256) through
    both engines: per-image forward, and the batched path for monoloco_p."""
    from monoloco_tpu.models import init_monoloco_params
    params, bn = init_monoloco_params(jax.random.PRNGKey(1), 34, out_dim, 256, 3)
    params = jax.tree_util.tree_map(np.array, params)
    bn = jax.tree_util.tree_map(np.array, bn)
    jnet = JaxLoco(model=(params, bn), mode='mono', net=net)
    net_t = Loco(model=(params, bn), mode='mono', net=net, device='cpu')
    kps, kks = _toy_batch(n_img=3, seed=9)
    for k, kk in zip(kps, kks):
        _assert_dicts_close(net_t.forward(k, kk), jnet.forward(k, kk))
    if net == 'monoloco_p':
        for ours, ref in zip(net_t.forward_batch(kps, kks), jnet.forward_batch(kps, kks)):
            _assert_dicts_close(ours, ref)


def test_refuses_what_is_not_ported(monkeypatch):
    """Nothing is refused now: a one-rank mesh (gloo, in this process)
    computes what no mesh computes (tests/test_torch_parallel.py holds
    several ranks); MC dropout runs (tests/test_torch_mc.py), stereo too
    (tests/test_torch_stereo.py). Every precision spelling of the JAX
    package is served, an unknown one raises."""
    params, bn = _toy_params()
    model = params_from_numpy(params, bn)
    assert Loco(model=model, mode='stereo', net='monoloco_pp', device='cpu').mode == 'stereo'
    assert Loco(model=model, n_dropout=3, device='cpu').n_dropout == 3
    rng = np.random.RandomState(0)
    kps = [rng.rand(m, 3, 17).astype(np.float32) * 300 for m in (3, 5, 1)]
    kks = [np.eye(3, dtype=np.float32) * 700] * 3

    def on_mesh(mesh):
        net = Loco(model=model, mesh=mesh, device='cpu')
        assert net.mesh is mesh and net.device == mesh.device
        return net.forward_batch(kps, kks)

    from monoloco_tpu_torch.parallel import launch
    for ours, ref in zip(launch(on_mesh, 1, device_type='cpu', timeout=60),
                         Loco(model=model, device='cpu').forward_batch(kps, kks)):
        for key in ('xyzd', 'bi', 'h'):
            assert np.array_equal(ours[key], ref[key])
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'fp16')
    with pytest.raises(ValueError, match='MONOLOCO_TPU_PRECISION'):
        serving_precision()
    for raw, canon in (('f32', 'float32'), ('float32', 'float32'), ('fp32', 'float32'),
                       ('highest', 'float32'), ('int8-a8', 'default'),
                       ('int8-xla', 'default'), ('default', 'default'), ('int8', 'int8'),
                       ('bf16', 'bfloat16'), ('bfloat16', 'bfloat16'),
                       ('tensorfloat32', 'tensorfloat32')):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', raw)
        assert serving_precision() == canon
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_no_card_means_no_silent_cpu_fallback(monkeypatch):
    """Without a card, the engine and the predict CLI refuse to run unless
    asked for the CPU (device='cpu', --disable-cuda)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params, bn = _toy_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Loco(model=params_from_numpy(params, bn), mode='mono')
    net = Loco(model=params_from_numpy(params, bn), mode='mono', device='cpu')
    assert net.device.type == 'cpu'
    kps, kks = _toy_batch(n_img=1)
    assert net.forward(kps[0], kks[0])['xyzd'].shape == (len(kps[0]), 4)


def test_predict_cli_without_a_card_needs_disable_cuda(monkeypatch, tmp_path):
    from monoloco_tpu_torch import run
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    img = str(tmp_path / 'im.png')
    shutil.copy(os.path.join(HERE, 'fixture_002282.png'), img)
    shutil.copy(os.path.join(HERE, 'fixture_002282.pifpaf.json'), img + '.pifpaf.json')
    argv = ['predict', img, '--model', os.path.join(GOLD, 'model_tpu.pkl'),
            '--output_types', 'json', '-o', str(tmp_path / 'out')]
    with pytest.raises(RuntimeError, match='--disable-cuda'):
        run.main(argv)
    net = run.main(argv + ['--disable-cuda'])
    assert net.device.type == 'cpu' and net.n_dispatches == 1
    assert os.listdir(tmp_path / 'out')


def test_jax_backend_is_cpu_for_the_reference():
    # The JAX side of these comparisons must be the CPU interpret path.
    assert jax.default_backend() == 'cpu'
    assert jnp.zeros(1).dtype == jnp.float32
