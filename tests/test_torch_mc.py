"""MC-dropout epistemic uncertainty and the bfloat16 / tensorfloat32
precisions of the port's engine, against the JAX package.

MC, exact: the test rebuilds the JAX package's keep-masks from its key tree
(`split(PRNGKey(0), n)`, per pass `split(rng, 4)` (legacy nets: 2), the
stages' keys `split(r[1], 2S).reshape(S, 2, 2)`, `bernoulli(key, 1 - p,
(rows, H))`, `monoloco_tpu/models/loco.py:160-220`) and its Laplace uniforms
(`uniform(PRNGKey(1), (100, rows), -0.5 + 1e-7, 0.5)`), injects both into
the port, and holds the port's epi to JAX `Loco.forward(...)['epi']` within
1e-4 relative (f32 on both sides; the port runs the BN-folded net, JAX the
unfolded one). MC, statistical: on the port's own generators, JAX's epi lies
inside the range that 20 seeds of the port span, widened by 10% of it on
each side. Per image against batched in the port: rtol 2e-4, JAX's own
bound (`tests/test_engine.py:170-186`).

bfloat16: the engine's MLP is `fused_forward_plain` of the bf16 pack exactly
(the K1-bf16 kernel's plain version on the CPU), the K^-1 inputs are the f32
route's bit for bit, and the decoded distance is within 0.02 mean relative
of the JAX f32 engine (XLA:CPU ignores the bfloat16 matmul precision, so the
JAX package computes f32 there). tensorfloat32 equals f32 on the CPU, with
TF32 on around the MLP's products only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import init_loco_params as jax_init_loco
from monoloco_tpu.models import init_monoloco_params as jax_init_monoloco
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu.network.decode import laplace_sampling as jax_laplace_sampling
from monoloco_tpu_torch.models import (dropout_masks, fold_eval_params, folded_forward,
                                       folded_forward_mc, n_dropout_sites, params_from_numpy,
                                       round_bf16)
from monoloco_tpu_torch.network import Loco, engine, laplace_sampling, laplace_uniforms
from monoloco_tpu_torch.ops import fused_forward_plain, pack_folded_weights
from monoloco_tpu_torch.utils import serve_storage, serving_precision

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
HIDDEN, STAGES, N_DROPOUT, P = 64, 2, 3, 0.2
KK = [[720., 0., 600.], [0., 720., 180.], [0., 0., 1.]]
KK2 = [[700., 0., 590.], [0., 700., 170.], [0., 0., 1.]]
RTOL_EXACT = 1e-4
NETS = {'monoloco_pp': ('loco', 9), 'monoloco_p': ('monoloco', 9), 'monoloco': ('monoloco', 2)}


def _perturb(params, bn, seed):
    """BN statistics and affine away from the identity, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for p, s in [(params['bn1'], bn['bn1'])] + (
            [(params['bn3'], bn['bn3'])] if 'bn3' in params else []) + [
            (params['stages'][k], bn['stages'][k]) for k in ('bn1', 'bn2')]:
        shape = np.shape(s['mean'])
        s['mean'] = rng.normal(0, 0.1, shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        p['scale'] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        p['bias'] = rng.normal(0, 0.05, shape).astype(np.float32)
    return params, bn


def _toy(net, hidden=HIDDEN, stages=STAGES, seed=0):
    """numpy (params, bn) of a toy net, the distance channel's bias at 15 m."""
    arch, out = NETS[net]
    init = jax_init_loco if arch == 'loco' else jax_init_monoloco
    params, bn = init(jax.random.PRNGKey(seed), 34, out, hidden, stages)
    params = jax.tree_util.tree_map(np.array, params)
    bn = jax.tree_util.tree_map(np.array, bn)
    head = 'w_fin' if arch == 'loco' else 'w2'
    params[head]['b'][0 if net == 'monoloco' else 2] += 15.0
    return _perturb(params, bn, seed + 1)


def _kps(m, seed):
    rng = np.random.default_rng(seed)
    kps = np.zeros((m, 3, 17), np.float32)
    centre = rng.uniform([200, 100], [1000, 300], size=(m, 2))
    kps[:, 0] = centre[:, :1] + rng.uniform(-30, 30, size=(m, 17))
    kps[:, 1] = centre[:, 1:] + rng.uniform(-80, 80, size=(m, 17))
    kps[:, 2] = rng.uniform(0.3, 1, size=(m, 17))
    return kps


def _jax_mc_draws(rows, arch, n=N_DROPOUT, hidden=HIDDEN, stages=STAGES, p=P):
    """JAX's keep-masks, site by site in the port's order, and its uniforms."""
    sites = [[] for _ in range(n_dropout_sites(stages, arch))]
    for rng in jax.random.split(jax.random.PRNGKey(0), n):
        r = jax.random.split(rng, 4 if arch == 'loco' else 2)
        stage_keys = jax.random.split(r[1], 2 * stages).reshape(stages, 2, 2)
        keys = [r[0]] + [stage_keys[i, j] for i in range(stages) for j in (0, 1)]
        if arch == 'loco':
            keys.append(r[2])
        for site, key in zip(sites, keys):
            site.append(np.asarray(jax.random.bernoulli(key, 1.0 - p, (rows, hidden))))
    u = jax.random.uniform(jax.random.PRNGKey(1), (engine.N_SAMPLES, rows),
                           minval=-0.5 + 1e-7, maxval=0.5)
    return [torch.from_numpy(np.stack(s)) for s in sites], torch.from_numpy(np.array(u))


def _nets(net, n_dropout=N_DROPOUT, seed=0):
    params, bn = _toy(net, seed=seed)
    jnet = JaxLoco(model=(params, bn), mode='mono', net=net, n_dropout=n_dropout)
    tnet = Loco(model=(params, bn), mode='mono', net=net, device='cpu', n_dropout=n_dropout)
    return jnet, tnet


@pytest.mark.parametrize('net', list(NETS))
def test_mc_epi_per_image_matches_jax_given_its_draws(net):
    """5 detections in bucket 8, n_dropout 3, hidden 64, 2 stages."""
    jnet, tnet = _nets(net)
    kps = _kps(5, seed=1)
    ref = np.asarray(jnet.forward(kps, KK)['epi'])
    ours = tnet.forward(kps, KK, mc=_jax_mc_draws(8, NETS[net][0]))['epi']
    assert ours.shape == (5,) and (ref > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL_EXACT, atol=0)


@pytest.mark.parametrize('net', ['monoloco_pp', 'monoloco_p'])
def test_mc_epi_batched_matches_jax_given_its_draws(net):
    """Three images of 5, 3 and 4 detections share bucket 8; JAX's vmap
    over images closes over the same keys, so every image has the same
    masks and uniforms."""
    jnet, tnet = _nets(net)
    kps_list = [_kps(5, seed=2), _kps(3, seed=3), _kps(4, seed=4)]
    kks = [KK, KK2, KK]
    refs = jnet.forward_batch(kps_list, kks)
    ours = tnet.forward_batch(kps_list, kks, mc=_jax_mc_draws(8, NETS[net][0]))
    assert tnet.n_dispatches == 1
    for o, r, k in zip(ours, refs, kps_list):
        assert o['epi'].shape == (len(k),)
        np.testing.assert_allclose(o['epi'], np.asarray(r['epi']), rtol=RTOL_EXACT, atol=0)


@pytest.mark.parametrize('net', ['monoloco_pp', 'monoloco'])
def test_mc_epi_statistically_matches_jax_on_the_ports_draws(net):
    """n_dropout 10: JAX's epi inside the range of 20 seeds of the port,
    widened by 10% of it on each side, for every detection."""
    jnet, tnet = _nets(net, n_dropout=10)
    kps = _kps(5, seed=5)
    ref = np.asarray(jnet.forward(kps, KK)['epi'])
    sites = n_dropout_sites(STAGES, NETS[net][0])
    runs = np.stack([tnet.forward(kps, KK, mc=(
        dropout_masks(10, 8, HIDDEN, sites, P, 'cpu', seed=s),
        laplace_uniforms(engine.N_SAMPLES, 8, 'cpu', seed=100 + s)))['epi'] for s in range(20)])
    lo, hi = runs.min(0), runs.max(0)
    width = hi - lo
    assert (width > 0).all()
    assert ((ref >= lo - 0.1 * width) & (ref <= hi + 0.1 * width)).all(), (ref, lo, hi)


@pytest.mark.parametrize('net', ['monoloco_pp', 'monoloco_p'])
def test_mc_epi_batched_matches_per_image(net):
    """Per-image and batched MC on the port's own generators, where the
    per-image buckets (4) equal the batch bucket: rtol 2e-4."""
    _, tnet = _nets(net, n_dropout=2, seed=2)
    kps_list = [_kps(3, seed=6), _kps(4, seed=7)]
    kks = [KK, KK2]
    for kps, kk, out_b in zip(kps_list, kks, tnet.forward_batch(kps_list, kks)):
        epi_s = tnet.forward(kps, kk)['epi']
        assert (out_b['epi'] > 0).all()
        np.testing.assert_allclose(out_b['epi'], epi_s, rtol=2e-4)


def test_mc_draws_are_reproducible_and_keep_one_minus_p():
    """A fresh generator per call: the same draws twice, the keep share
    near 1 - p, the uniforms inside [-0.5 + 1e-7, 0.5); `mc_last` keeps the
    draws of the last dispatch."""
    _, tnet = _nets('monoloco_pp', n_dropout=4)
    (m1, u1), (m2, u2) = tnet.draw_mc(32), tnet.draw_mc(32)
    assert len(m1) == n_dropout_sites(STAGES, 'loco') == 2 * STAGES + 2
    assert all(torch.equal(a, b) for a, b in zip(m1, m2)) and torch.equal(u1, u2)
    assert m1[0].shape == (4, 32, HIDDEN) and m1[0].dtype == torch.bool
    keep = float(torch.stack(m1).float().mean())
    assert abs(keep - (1 - P)) < 0.01
    assert float(u1.min()) >= -0.5 + 1e-7 and float(u1.max()) < 0.5
    assert not torch.equal(dropout_masks(4, 32, HIDDEN, 1, P, 'cpu', seed=1)[0], m1[0])
    tnet.forward(_kps(5, seed=8), KK)
    masks, u = tnet.mc_last
    assert masks[0].shape == (4, 8, HIDDEN) and u.shape == (engine.N_SAMPLES, 8)
    assert len(dropout_masks(2, 8, HIDDEN, 5, P, 'cpu')) == 5


@pytest.mark.parametrize('arch', ['loco', 'monoloco'])
def test_mc_forward_without_dropping_is_the_folded_forward(arch):
    """All-keep masks with p = 0 give the folded eval forward exactly, one
    copy per pass."""
    net = 'monoloco_pp' if arch == 'loco' else 'monoloco'
    params, bn = params_from_numpy(*_toy(net))
    folded = fold_eval_params(params, bn, arch=arch)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 6, 34)).astype(np.float32))
    masks = [torch.ones((3, 1, 6, HIDDEN), dtype=torch.bool)
             for _ in range(n_dropout_sites(STAGES, arch))]
    out = folded_forward_mc(folded, x, masks, 0.0, arch)
    ref = folded_forward(folded, x, arch)
    assert out.shape == (3,) + ref.shape
    for i in range(3):
        assert torch.equal(out[i], ref)


def test_laplace_sampling_matches_jax_given_its_uniforms():
    rng = np.random.default_rng(10)
    outputs = np.stack([rng.uniform(5, 30, 7), rng.uniform(-2, 2, 7)], 1).astype(np.float32)
    u = jax.random.uniform(jax.random.PRNGKey(1), (100, 7), minval=-0.5 + 1e-7, maxval=0.5)
    ref = np.asarray(jax_laplace_sampling(jnp.asarray(outputs), 100))
    ours = laplace_sampling(torch.from_numpy(outputs), 100, u=torch.from_numpy(np.asarray(u)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-5)
    # leading axes share the uniforms; without u they come from seed 1
    both = laplace_sampling(torch.from_numpy(np.stack([outputs, outputs])), 100)
    assert both.shape == (2, 100, 7) and torch.equal(both[0], both[1])
    assert torch.equal(both[0], laplace_sampling(torch.from_numpy(outputs), 100,
                                                 u=laplace_uniforms(100, 7, 'cpu')))


def test_stereo_keeps_epi_at_zeros_with_n_dropout():
    from monoloco_tpu_torch.models import init_loco_params
    net = Loco(model=init_loco_params(0, 68, 10, 128, 2), mode='stereo', device='cpu',
               n_dropout=3)
    kps = _kps(3, seed=11)
    assert list(net.forward(kps, KK, keypoints_r=kps)['epi']) == [0.0] * 3
    assert net.mc_last is None


def test_mc_runs_f32_under_int8_and_bfloat16(monkeypatch):
    """Under int8 the main dispatch routes dyn8 and under bfloat16 the
    K1-bf16 plain version, while the MC dispatch stays f32: epi equals the
    float32 engine's bit for bit."""
    params, bn = _toy('monoloco_pp', hidden=128)
    kps = _kps(5, seed=12)
    monkeypatch.setattr(engine, '_INT8_MIN_ROWS', 8)
    epis = {}
    for precision in ('float32', 'int8', 'bfloat16'):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
        net = Loco(model=(params, bn), mode='mono', device='cpu', n_dropout=3)
        out = net.forward(kps, KK)
        epis[precision] = out['epi']
        assert net.n_dispatches_int8 == (precision == 'int8')
    assert (epis['float32'] > 0).all()
    np.testing.assert_array_equal(epis['int8'], epis['float32'])
    np.testing.assert_array_equal(epis['bfloat16'], epis['float32'])


# --- the bfloat16 and tensorfloat32 precisions ------------------------------

def _fixture_inputs():
    import json
    from monoloco_tpu_torch.network import load_calibration, preprocess_pifpaf
    with open(os.path.join(HERE, 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    im_size = (1238, 374)
    _, keypoints = preprocess_pifpaf(anns, im_size, enlarge_boxes=False)
    return keypoints, load_calibration('kitti', im_size)


def _record_mlp_inputs(monkeypatch):
    seen = []
    real = engine._mlp_forward

    def spy(weights, inputs, arch):
        seen.append(inputs.clone())
        return real(weights, inputs, arch)

    monkeypatch.setattr(engine, '_mlp_forward', spy)
    return seen


@pytest.mark.parametrize('spelling', ['bf16', 'bfloat16'])
def test_bfloat16_mlp_is_the_k1_bf16_plain_version(monkeypatch, spelling):
    """A Loco net of hidden % 128 == 0 (the byte-compat checkpoint, hidden
    128) routes every dispatch, of any size, to K1-bf16: on the CPU its
    plain version, whose output the engine decodes unchanged."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', spelling)
    net = Loco(model=MODEL, mode='mono', device='cpu')
    assert net.precision == 'bfloat16' and net.serve_storage == 'f32'
    packed = net.mlp_weights['packed_bf16']
    assert packed[2].dtype == torch.bfloat16
    ref_pack = pack_folded_weights(net.folded, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(packed, ref_pack))
    for rows in (1, 8, 77):
        x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, 34))
                             .astype(np.float32))
        assert torch.equal(engine._mlp_forward(net.mlp_weights, x, 'loco'),
                           fused_forward_plain(ref_pack, x))
    seen = _record_mlp_inputs(monkeypatch)
    keypoints, kk = _fixture_inputs()
    out = net.forward(keypoints, kk)
    from monoloco_tpu_torch.network import extract_outputs
    ref = extract_outputs(fused_forward_plain(ref_pack, seen[0]))
    np.testing.assert_array_equal(out['d'], ref['d'][:len(keypoints)].numpy())


def test_bfloat16_keeps_the_k_inverse_inputs_of_f32(monkeypatch):
    """K^-1 stays f32: the MLP's inputs under bfloat16 equal the float32
    route's bit for bit, per image and batched."""
    seen = _record_mlp_inputs(monkeypatch)
    keypoints, kk = _fixture_inputs()
    for precision in ('float32', 'bfloat16'):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
        net = Loco(model=MODEL, mode='mono', device='cpu')
        net.forward(keypoints, kk)
        net.forward_batch([keypoints, keypoints[:3]], [kk, kk])
    assert len(seen) == 4
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])


def test_bfloat16_distance_within_budget_of_jax_f32(monkeypatch):
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'bfloat16')
    keypoints, kk = _fixture_inputs()
    d = Loco(model=MODEL, mode='mono', device='cpu').forward(keypoints, kk)['d']
    ref = np.asarray(JaxLoco(model=MODEL, mode='mono').forward(keypoints, kk)['d'])
    rel = float(np.abs(d - ref).mean() / np.abs(ref).mean())
    assert 0 < rel < 0.02, rel


def test_bfloat16_legacy_net_runs_bf16_operands_without_a_kernel(monkeypatch):
    """The legacy 'monoloco' net has no kernel: its products take
    bf16-rounded operands, exact in f32, and f32 sums."""
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'bfloat16')
    params, bn = _toy('monoloco_p', hidden=64)
    net = Loco(model=(params, bn), mode='mono', net='monoloco_p', device='cpu')
    assert net.mlp_weights['packed_bf16'] is None
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(9, 34)).astype(np.float32))
    out = engine._mlp_forward(net.mlp_weights, x, 'monoloco')
    folded = net.mlp_weights['folded'].folded()
    assert torch.equal(out, folded_forward(folded, x, 'monoloco', operand=round_bf16))
    y = torch.relu(round_bf16(x) @ round_bf16(folded['l0']['w']) + folded['l0']['b'])
    exact = (round_bf16(x).double() @ round_bf16(folded['l0']['w']).double()).float()
    assert torch.allclose(y, torch.relu(exact + folded['l0']['b']), rtol=1e-6, atol=1e-6)
    f32 = folded_forward(folded, x, 'monoloco')
    rel = float((out - f32).abs().mean() / f32.abs().mean())
    assert 0 < rel < 0.02


def test_tensorfloat32_is_f32_with_tf32_around_the_mlp_only(monkeypatch):
    """On the CPU TF32 changes nothing, so tensorfloat32 equals float32; TF32
    is on while the MLP's products run and off again after."""
    keypoints, kk = _fixture_inputs()
    outs = {}
    flags = []
    for precision in ('float32', 'tensorfloat32'):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
        net = Loco(model=MODEL, mode='mono', device='cpu')
        real = net.mlp_weights['folded'].forward

        def spy(x, real=real):
            flags.append(torch.backends.cuda.matmul.allow_tf32)
            return real(x)

        monkeypatch.setattr(net.mlp_weights['folded'], 'forward', spy)
        outs[precision] = net.forward(keypoints, kk)
        assert not torch.backends.cuda.matmul.allow_tf32
    assert flags == [False, True]
    for key in ('d', 'bi', 'xyzd'):
        np.testing.assert_array_equal(outs['tensorfloat32'][key], outs['float32'][key])


@pytest.mark.parametrize('raw,ok', [('auto', True), ('f32', True), ('bf16', True),
                                    ('fp16', False)])
def test_serve_storage_takes_the_jax_spellings(monkeypatch, raw, ok):
    monkeypatch.setenv('MONOLOCO_TPU_SERVE_STORAGE', raw)
    if ok:
        assert serve_storage() == 'f32'
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'bf16')
        assert serving_precision() == 'bfloat16'
    else:
        with pytest.raises(ValueError, match=r"MONOLOCO_TPU_SERVE_STORAGE='fp16': use "
                                             r"auto\|f32\|bf16"):
            Loco(model=MODEL, mode='mono', device='cpu')
