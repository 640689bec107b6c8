"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a CUDA device every test skips (the kernels have no
CPU mode). This file imports neither jax nor the JAX package, so it runs on
the GPU machine, where jax is not installed; tests/conftest.py imports jax,
so run it there with
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Weights come from a numpy seed with perturbed BN statistics. Tolerances:
 - int8 activations (dyn8, static a8w8): the kernel and the plain version
   quantize identically and differ only in the f32 sum order of the bf16
   layers. A last-ulp difference there can flip one rounding tie of a later
   quantization, which moves all outputs of that row by up to ~1e-2
   (measured on the H100: about 2-3% of the rows at hidden 1024 with normal
   inputs). So at most 10% of the rows may hold an output that differs by
   more than 1e-5 (1 + |ref|), no output by more than 5e-2, and the mean
   difference stays under 1e-3 of the mean output.
 - bf16 activations (K1 with bf16 weights, w8a16; csrc/wgmma_layer.cu):
   every H x H layer rounds its output to bf16 (the residual stays f32), and
   wgmma's f32 sums differ from the plain version's exact ones in the last
   bits, so some of the 8 x H roundings of a row flip (measured on the H100
   at hidden 1024: 15-100% of the rows, mean difference up to 2e-3 of the
   mean output). So no output may differ by more than
   5e-2, the mean difference stays under 5e-3 of the mean output, and the
   kernel is no further from the f32 MLP than 1.25 x the plain version is.
 - one layer of that kernel against `layer_plain`: the bf16 rule above
   (max abs 5e-2, mean 5e-3 of the mean output), and since only the order of
   one f32 sum differs, at most 1% of the bf16 outputs differ at all
   (measured on the H100: 0.01-0.06%) and the f32 residual of 'add_relu'
   stays within 1e-5 (1 + |y|).
 - f32 (K1 with f32 weights, 3xTF32 layers in csrc/wgmma_layer_kmajor.cu):
   max abs 1e-4; the kernel's products drop a_small w_small (below 2^-22 of
   a product) and the tensor cores sum in their own order.
 - one 3xTF32 layer against `f32_layer_plain`: within 1e-5 (1 + |ref|), and
   the residual of 'add_relu' likewise.
 - one dyn8 layer (row quantization + s8 layer) against `quantize_rows_plain`
   and `s8_layer_plain`: bit for bit, f32 and bf16 results and the residual;
   the int32 sums are exact and the epilogue keeps the plain float order.
 - one static a8w8 layer against `static_s8_layer_plain`: bit for bit, f32,
   bf16 and the next layer's int8 input, and the residual, for the same
   reasons.
A wrong kernel misses every one of these by orders of magnitude. A row never
depends on the rows around it (bit for bit).
"""

import numpy as np
import pytest
import torch

from monoloco_tpu_torch import ops
from monoloco_tpu_torch.models import fold_eval_params, folded_forward, init_loco_params
from monoloco_tpu_torch.ops import (dyn8_forward_plain, fused_forward_plain,
                                    fused_loco_forward, fused_loco_forward_dyn8_auto,
                                    fused_loco_forward_int8, fused_loco_forward_w8,
                                    int8_static_forward_plain, pack_folded_weights,
                                    pack_folded_weights_int8, pack_folded_weights_w8,
                                    w8_forward_plain)

pytestmark = pytest.mark.cuda

# kernel -> (entry on a pack, plain version, pack name, launches key, rule)
KERNELS = {
    'dyn8': (fused_loco_forward_dyn8_auto, dyn8_forward_plain, 'w8', 'dyn8_mlp', 'int8'),
    'k1_bf16': (lambda p, x: fused_loco_forward(None, x, packed=p), fused_forward_plain,
                'bf16', 'fused_mlp_bf16', 'bf16'),
    'k1_f32': (lambda p, x: fused_loco_forward(None, x, packed=p), fused_forward_plain,
               'f32', 'fused_mlp_f32', 'f32'),
    'k4': (fused_loco_forward_int8, int8_static_forward_plain, 'a8', 'int8_static_mlp', 'int8'),
    'k5': (fused_loco_forward_w8, w8_forward_plain, 'w8', 'w8_mlp', 'bf16'),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    return torch.device('cuda')


def _folded(in_dim, out_dim, hidden, device, seed=0):
    params, bn = init_loco_params(seed, in_dim, out_dim, hidden, 3)
    rng = np.random.default_rng(seed)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = torch.from_numpy(rng.normal(0, 0.1, tuple(s['mean'].shape)).astype(np.float32))
        s['var'] = torch.from_numpy(rng.uniform(0.5, 2.0, tuple(s['var'].shape)).astype(np.float32))
    folded = fold_eval_params(params, bn)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
    return to(folded)


def _packs(folded, in_dim, device):
    calib = _inputs(2048, in_dim, device, seed=5)
    return {'w8': pack_folded_weights_w8(folded), 'a8': pack_folded_weights_int8(folded, calib),
            'bf16': pack_folded_weights(folded), 'f32': pack_folded_weights(folded, torch.float32)}


def _packed(in_dim, out_dim, hidden, device, seed=0):
    return pack_folded_weights_w8(_folded(in_dim, out_dim, hidden, device, seed))


def _inputs(m, in_dim, device, seed=1):
    x = np.random.default_rng(seed).normal(size=(m, in_dim)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _check(rule, out, ref, f32_ref):
    diff = (out - ref).abs()
    if rule == 'f32':
        assert float(diff.max()) <= 1e-4, float(diff.max())
        return
    assert float(diff.max()) <= 5e-2, float(diff.max())
    if rule == 'int8':
        rows_off = float((diff > 1e-5 * (1 + ref.abs())).any(dim=1).float().mean())
        assert rows_off <= 0.1, rows_off
        assert float(diff.mean()) <= 1e-3 * float(ref.abs().mean()), float(diff.mean())
    else:
        assert float(diff.mean()) <= 5e-3 * float(ref.abs().mean()), float(diff.mean())
        if out.shape[0] >= 512:
            kernel_err = float((out - f32_ref).abs().mean())
            plain_err = float((ref - f32_ref).abs().mean())
            assert kernel_err <= 1.25 * plain_err, (kernel_err, plain_err)


@pytest.mark.parametrize('kernel', list(KERNELS))
@pytest.mark.parametrize('in_dim,out_dim,hidden', [(34, 9, 128), (68, 10, 256), (34, 9, 1024)])
def test_kernel_matches_plain(cuda_device, kernel, in_dim, out_dim, hidden):
    entry, plain, pack, key, rule = KERNELS[kernel]
    folded = _folded(in_dim, out_dim, hidden, cuda_device)
    packed = _packs(folded, in_dim, cuda_device)[pack]
    for m in (1, 77, 512):
        x = _inputs(m, in_dim, cuda_device, seed=m)
        before = ops.launches[key]
        out = entry(packed, x)
        torch.cuda.synchronize()
        assert ops.launches[key] == before + 1
        assert out.shape == (m, out_dim) and bool(torch.isfinite(out).all())
        _check(rule, out, plain(packed, x), folded_forward(folded, x))


@pytest.mark.parametrize('kernel', list(KERNELS))
def test_kernel_rows_are_independent(cuda_device, kernel):
    entry, _, pack, _, _ = KERNELS[kernel]
    packed = _packs(_folded(34, 9, 128, cuda_device), 34, cuda_device)[pack]
    big = _inputs(512, 34, cuda_device, seed=9)
    out_big = entry(packed, big)
    for m in (1, 8, 77):
        assert torch.equal(entry(packed, big[:m].contiguous()), out_big[:m])


def test_kernel_refuses_bad_inputs(cuda_device):
    packed = _packed(34, 9, 128, cuda_device)
    with pytest.raises(ValueError, match='dtype'):
        fused_loco_forward_dyn8_auto(packed, _inputs(8, 34, cuda_device).double())
    with pytest.raises(ValueError, match='shape'):
        fused_loco_forward_dyn8_auto(packed, _inputs(8, 33, cuda_device))
    with pytest.raises(ValueError, match='contiguous'):
        fused_loco_forward_dyn8_auto(packed, _inputs(8, 68, cuda_device)[:, ::2])
    with pytest.raises(ValueError, match='is on'):
        fused_loco_forward_dyn8_auto(tuple(t.cpu() for t in packed), _inputs(8, 34, cuda_device))


@pytest.mark.parametrize('kernel', list(KERNELS))
def test_every_kernel_runs_at_hidden_2048(cuda_device, kernel):
    """Every kernel is layered: its activations cross device memory between
    launches and none stay on the SM, so hidden 2048 runs (K4's former
    16-row tile refused it) and is held to plain under the kernel's rule.
    (The s8 layers at hidden 2048: |acc| may pass 2^24, where its f32
    conversion rounds half to even on both sides.)"""
    entry, plain, pack, _, rule = KERNELS[kernel]
    hidden = 2048
    folded = _folded(34, 9, hidden, cuda_device)
    packed = _packs(folded, 34, cuda_device)[pack]
    for m in (1, 77, 512):
        x = _inputs(m, 34, cuda_device, seed=m)
        out = entry(packed, x)
        _check(rule, out, plain(packed, x), folded_forward(folded, x))


def test_entries_refuse_hidden_off_the_128_grid(cuda_device):
    folded = _folded(34, 9, 192, cuda_device)
    x = _inputs(8, 34, cuda_device)
    with pytest.raises(ValueError, match='hidden % 128'):
        fused_loco_forward(None, x, packed=pack_folded_weights(folded))
    with pytest.raises(ValueError, match='hidden % 128'):
        fused_loco_forward_w8(pack_folded_weights_w8(folded), x)
    a = torch.zeros((8, 192), dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros((192, 192), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match='hidden % 128'):
        ops.loco_layer(a, w, torch.zeros(192, device=cuda_device), 'relu')


@pytest.mark.parametrize('epilogue', ['store', 'relu', 'add_relu'])
@pytest.mark.parametrize('w8', [False, True])
@pytest.mark.parametrize('hidden', [128, 256, 1024])
def test_layer_kernel_matches_plain_layer(cuda_device, hidden, w8, epilogue):
    rng = np.random.default_rng(hidden + int(w8))
    w = torch.from_numpy((rng.normal(size=(hidden, hidden)) / hidden ** 0.5)
                         .astype(np.float32)).to(cuda_device)
    if w8:
        w, oscale = ops.quant_weight(w)
        w, oscale, key = w.contiguous(), oscale.contiguous(), 'wgmma_layer_w8'
    else:
        w, oscale, key = w.to(torch.bfloat16).contiguous(), None, 'wgmma_layer_bf16'
    bias = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32)).to(cuda_device)
    for m in (1, 77, 512):
        a = _inputs(m, hidden, cuda_device, seed=m).to(torch.bfloat16)
        y0 = _inputs(m, hidden, cuda_device, seed=m + 1)
        y_k, y_p = y0.clone(), y0.clone()
        before = ops.launches[key]
        out = ops.loco_layer(a, w, bias, epilogue, oscale, y_k)
        torch.cuda.synchronize()
        assert ops.launches[key] == before + 1
        ref = ops.layer_plain(a, w, bias, epilogue, oscale, y_p)
        assert out.dtype == torch.bfloat16 and out.shape == (m, hidden)
        diff = (out.float() - ref.float()).abs()
        assert float(diff.max()) <= 5e-2
        assert float(diff.mean()) <= 5e-3 * float(ref.float().abs().mean())
        assert float((diff > 0).float().mean()) <= 0.01
        assert bool(((y_k - y_p).abs() <= 1e-5 * (1 + y_p.abs())).all())


def _layer_operands(hidden, seed, device):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(hidden, hidden)) / hidden ** 0.5)
                         .astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32)).to(device)
    return w, bias


@pytest.mark.parametrize('epilogue', ['store', 'relu', 'add_relu'])
@pytest.mark.parametrize('hidden', [128, 256, 1024])
def test_dyn8_layer_kernel_is_its_plain_layer_bit_for_bit(cuda_device, hidden, epilogue):
    w, bias = _layer_operands(hidden, hidden + 7, cuda_device)
    wq, oscale = ops.quant_weight(w)
    wq, oscale = wq.contiguous(), oscale.contiguous()
    for m in (1, 77, 512):
        act = _inputs(m, hidden, cuda_device, seed=m)
        y0 = _inputs(m, hidden, cuda_device, seed=m + 1)
        y_k, y_p = y0.clone(), y0.clone()
        before = ops.launches['wgmma_layer_dyn8']
        out, out_bf = ops.loco_layer_dyn8(act, wq, oscale, bias, epilogue, y_k)
        torch.cuda.synchronize()
        assert ops.launches['wgmma_layer_dyn8'] == before + 1
        q, s_row = ops.quantize_rows_plain(act)
        ref, ref_bf = ops.s8_layer_plain(q, s_row, ops.transpose_int8_plain(wq), oscale, bias,
                                         epilogue, y_p)
        assert out.dtype == torch.float32 and out_bf.dtype == torch.bfloat16
        assert torch.equal(out, ref) and torch.equal(out_bf, ref_bf)
        assert torch.equal(y_k, y_p)


@pytest.mark.parametrize('epilogue', ['store', 'relu', 'add_relu'])
@pytest.mark.parametrize('hidden', [128, 256, 1024])
def test_static_layer_kernel_is_its_plain_layer_bit_for_bit(cuda_device, hidden, epilogue):
    w, bias = _layer_operands(hidden, hidden + 13, cuda_device)
    wq, wscale = ops.quant_weight(w)
    s_in = torch.full((), 3.0 / 127.0, device=cuda_device)
    wq, oscale = wq.contiguous(), (s_in * wscale).contiguous()
    inv_next = torch.full((1,), 127.0 / 2.0, device=cuda_device)    # clips some outputs
    for m in (1, 77, 512):
        q = ops.quantize_static_plain(_inputs(m, hidden, cuda_device, seed=m), 1 / s_in)
        y0 = _inputs(m, hidden, cuda_device, seed=m + 1)
        y_k, y_p = y0.clone(), y0.clone()
        before = ops.launches['wgmma_layer_static']
        out, out_bf, q_next = ops.loco_layer_static(q, wq, oscale, bias, epilogue, inv_next,
                                                    y_k)
        torch.cuda.synchronize()
        assert ops.launches['wgmma_layer_static'] == before + 1
        ref, ref_bf, ref_q = ops.static_s8_layer_plain(q, ops.transpose_int8_plain(wq), oscale,
                                                       bias, epilogue, inv_next, y_p)
        assert out.dtype == torch.float32 and out_bf.dtype == torch.bfloat16
        assert q_next.dtype == torch.int8 and q_next.shape == (m, hidden)
        assert torch.equal(out, ref) and torch.equal(out_bf, ref_bf)
        assert torch.equal(q_next, ref_q) and torch.equal(y_k, y_p)


@pytest.mark.parametrize('epilogue', ['store', 'relu', 'add_relu'])
@pytest.mark.parametrize('hidden', [128, 256, 1024])
def test_tf32x3_layer_kernel_matches_plain_layer(cuda_device, hidden, epilogue):
    w, bias = _layer_operands(hidden, hidden + 11, cuda_device)
    for m in (1, 77, 512):
        a = _inputs(m, hidden, cuda_device, seed=m)
        y0 = _inputs(m, hidden, cuda_device, seed=m + 1)
        y_k, y_p = y0.clone(), y0.clone()
        before = ops.launches['wgmma_layer_f32']
        out = ops.loco_layer_f32(a, w, bias, epilogue, y_k)
        torch.cuda.synchronize()
        assert ops.launches['wgmma_layer_f32'] == before + 1
        ref = ops.f32_layer_plain(a, w, bias, epilogue, y_p)
        assert out.dtype == torch.float32 and out.shape == (m, hidden)
        assert bool(((out - ref).abs() <= 1e-5 * (1 + ref.abs())).all())
        assert bool(((y_k - y_p).abs() <= 1e-5 * (1 + y_p.abs())).all())


def _pairing_rows(m, r, device, seed=0):
    """The (m * r, 68) stereo inputs `preprocess_monstereo` makes from m left
    and r right pifpaf-like poses over a KITTI image."""
    from monoloco_tpu_torch.network import load_calibration, preprocess_monstereo
    rng = np.random.default_rng(seed)

    def poses(n):
        kps = rng.uniform(0, 1, size=(n, 3, 17)).astype(np.float32)
        kps[:, 0] = kps[:, 0] * 800 + 200
        kps[:, 1] = kps[:, 1] * 200 + 80
        return torch.from_numpy(kps).to(device)

    kk = torch.tensor(load_calibration('kitti', (1238, 374)), device=device)
    inputs, _ = preprocess_monstereo(poses(m), poses(r), kk)
    return inputs.contiguous()


def test_dyn8_at_68_to_10_on_stereo_pairing_rows(cuda_device):
    """MonStereo's widths at hidden 1024, 3 stages, on the rows the stereo
    engine feeds it (m x r pairings), under the int8 rule; rows bit-equal
    whatever the batch around them."""
    folded = _folded(68, 10, 1024, cuda_device)
    packed = pack_folded_weights_w8(folded)
    for m, r in ((7, 11), (32, 32), (64, 256)):
        x = _pairing_rows(m, r, cuda_device, seed=m)
        before = ops.launches['dyn8_mlp']
        out = fused_loco_forward_dyn8_auto(packed, x)
        torch.cuda.synchronize()
        assert ops.launches['dyn8_mlp'] == before + 1
        assert out.shape == (m * r, 10) and bool(torch.isfinite(out).all())
        _check('int8', out, dyn8_forward_plain(packed, x), folded_forward(folded, x))
    for n in (1, 77, 1024):
        assert torch.equal(fused_loco_forward_dyn8_auto(packed, x[:n].contiguous()), out[:n])


@pytest.mark.parametrize('hidden', [128, 256, 1024])
def test_relu_chain_matches_plain(cuda_device, hidden):
    """K6 (8 bf16 relu layers on csrc/wgmma_layer.cu) against
    `relu_chain_plain`, under the bf16 rule: max abs 5e-2 and mean 5e-3 of
    the output's, and no further from the f32 chain than 1.25x the plain
    version (weights N(0, 2 / H), so the activations stay O(1))."""
    rng = np.random.default_rng(hidden)
    ws = [torch.from_numpy((rng.normal(size=(hidden, hidden)) * (2 / hidden) ** 0.5)
                           .astype(np.float32)).to(cuda_device) for _ in range(8)]
    ws_bf = [w.to(torch.bfloat16) for w in ws]
    for m in (1, 77, 512):
        x = _inputs(m, hidden, cuda_device, seed=m).to(torch.bfloat16)
        before = ops.launches['relu_chain_bf16']
        out = ops.relu_chain(x, ws_bf)
        torch.cuda.synchronize()
        assert ops.launches['relu_chain_bf16'] == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == (m, hidden)
        ref = ops.relu_chain_plain(x, ws_bf).float()
        f32 = x.float()
        for w in ws_bf:
            f32 = torch.relu(f32 @ w.float())
        diff = (out.float() - ref).abs()
        assert float(diff.max()) <= 5e-2 * float(ref.abs().max())
        assert float(diff.mean()) <= 5e-3 * float(ref.abs().mean())
        assert float((out.float() - f32).abs().mean()) <= 1.25 * float((ref - f32).abs().mean())


def test_stereo_engine_int8_against_float32(cuda_device, monkeypatch):
    """The stereo engine at MonStereo's widths under int8: a 16 x 32 pairing
    dispatch (512 rows) routes to the dyn8 kernel; its distances stay within
    the dyn8 budget (0.02 mean relative) of the float32 engine's where both
    chose the same right pose."""
    from monoloco_tpu_torch.network import Loco
    params, bn = init_loco_params(2, 68, 10, 1024, 3)
    params['w_fin']['b'][0:3] += torch.tensor([np.pi / 2, np.pi / 2, 15.0])
    rng = np.random.default_rng(3)
    kps = rng.uniform(0, 1, size=(16, 3, 17)).astype(np.float32)
    kps[:, 0] = kps[:, 0] * 800 + 200
    kps[:, 1] = kps[:, 1] * 200 + 80
    kps_r = np.concatenate([kps, kps]).copy()
    kps_r[:, 0] -= rng.uniform(10, 80, size=(32, 1)).astype(np.float32)
    kk = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]
    outs = {}
    for precision in ('int8', 'float32'):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
        net = Loco((params, bn), mode='stereo', device=cuda_device)
        before = ops.launches['dyn8_mlp']
        outs[precision] = net.forward(kps, kk, keypoints_r=kps_r)
        torch.cuda.synchronize()
        routed = precision == 'int8'
        assert net.n_dispatches_int8 == int(routed)
        assert ops.launches['dyn8_mlp'] == before + int(routed)
    same = outs['int8']['aux_idx'] == outs['float32']['aux_idx']
    assert same.mean() >= 0.5
    d8, d32 = outs['int8']['d'][same], outs['float32']['d'][same]
    assert np.isfinite(d8).all()
    assert np.abs(d8 - d32).mean() / np.abs(d32).mean() < 0.02


def _mono_keypoints(m, seed):
    rng = np.random.default_rng(seed)
    kps = rng.uniform(0, 1, size=(m, 3, 17)).astype(np.float32)
    kps[:, 0] = kps[:, 0] * 800 + 200
    kps[:, 1] = kps[:, 1] * 200 + 80
    return kps


KK_KITTI = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]


@pytest.mark.parametrize('spelling', ['bf16', 'bfloat16'])
def test_mono_engine_bf16_launches_k1_bf16_on_every_dispatch(cuda_device, monkeypatch, spelling):
    """Under bf16 a Loco net of hidden % 128 == 0 runs K1-bf16 on every
    dispatch, per image (8 rows) and batched (3 images, 48 rows), never
    dyn8; its distances stay within 0.02 mean relative of float32's."""
    from monoloco_tpu_torch.network import Loco
    params, bn = init_loco_params(0, 34, 9, 1024, 3)
    params['w_fin']['b'][2] += 15.0
    kps = [_mono_keypoints(m, seed) for m, seed in ((5, 1), (16, 2), (9, 3))]
    outs = {}
    for precision in ('float32', spelling):
        monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
        net = Loco((params, bn), mode='mono', device=cuda_device)
        before = dict(ops.launches)
        one = net.forward(kps[0], KK_KITTI)
        many = net.forward_batch(kps, [KK_KITTI] * 3)
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in ops.launches.items() if n != before[k]}
        assert ran == ({} if precision == 'float32' else {'fused_mlp_bf16': 2})
        outs[precision] = np.concatenate([one['d'][:, 0]] + [o['d'][:, 0] for o in many])
    d, d32 = outs[spelling], outs['float32']
    assert np.isfinite(d).all() and 0 < np.abs(d - d32).mean() / np.abs(d32).mean() < 0.02


@pytest.mark.parametrize('precision', ['float32', 'int8', 'bf16', 'tensorfloat32'])
def test_mc_epistemic_on_the_card_matches_the_cpu_on_its_draws(cuda_device, monkeypatch,
                                                              precision):
    """MC dropout stays f32 under every precision: the card's epi, per image
    and batched, equals the CPU's plain f32 recomputation from the masks and
    uniforms the card drew within 1e-4 relative; TF32 is off after."""
    from monoloco_tpu_torch.network import Loco
    params, bn = init_loco_params(1, 34, 9, 256, 2)
    params['w_fin']['b'][2] += 15.0
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
    net = Loco((params, bn), mode='mono', device=cuda_device, n_dropout=4)
    cpu = Loco((params, bn), mode='mono', device='cpu', n_dropout=4)
    kps = [_mono_keypoints(m, seed) for m, seed in ((5, 4), (7, 5))]
    for outs in ([net.forward(kps[0], KK_KITTI)], net.forward_batch(kps, [KK_KITTI] * 2)):
        masks, u = net.mc_last
        mc = ([m.cpu() for m in masks], u.cpu())
        if len(outs) == 1:
            ref = [cpu.forward(kps[0], KK_KITTI, mc=mc)]
        else:
            ref = cpu.forward_batch(kps, [KK_KITTI] * 2, mc=mc)
        for o, r in zip(outs, ref):
            assert (o['epi'] > 0).all()
            np.testing.assert_allclose(o['epi'], r['epi'], rtol=1e-4, atol=0)
    assert not torch.backends.cuda.matmul.allow_tf32
