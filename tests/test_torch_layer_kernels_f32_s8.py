"""The layered forwards of K1-f32 and dyn8 (`csrc/wgmma_layer_kmajor.cu`
with the input projection and heads of `csrc/wgmma_layer.cu`), launch by
launch, on the CPU: the plain versions of their launches chained as the
kernels chain them.

- Bit for bit, each chain equals the plain version of the whole forward,
  `fused_forward_plain` (f32 pack) and `dyn8_forward_plain` (w8 pack): the
  split into launches changes no float operation.
- Against the JAX package's Pallas kernels in interpret mode, on the JAX
  package's own packs. K1-f32 is held to tests/test_torch_fused_mlp_family.py's
  atol 1e-5. dyn8 at hidden 128 is held to tests/test_torch_fused_mlp.py's
  rule, mean error 1e-5 of the mean output and max 1e-2. The plain version
  sums the bf16 input projection in float64 where the Pallas kernel sums in
  f32, and a last-ulp difference there can flip a quantization tie, which
  moves a whole row. At hidden 256 that happened in up to 1.6% of the rows
  over five input seeds (mean error up to 1.05e-4 of the mean output, max
  2.3e-3), so there at most 5% of the rows may hold an output off by more
  than 1e-5 (1 + |ref|), and the max stays under 1e-2. At both widths the
  dyn8 chain is no further from the f32 MLP than 1.25x the Pallas kernel is.
- The 3xTF32 parts: tf32 mantissas, within 2^-22 |t| of t; the emulated
  3xTF32 chain at full width (hidden 1024, 3 stages, chip_smoke's weights
  and inputs, 256 rows) within 1e-5 of the exact f32 forward, a tenth of the
  card's 1e-4 rule for the kernel.
- The transposed stacks hold the same values.

Weights: the JAX fold with perturbed BN statistics, 3 stages, hidden 128
and 256, 34 -> 9 and 68 -> 10; inputs from a numpy seed, m = 1, 77, 256.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import folded_forward as jax_folded_forward
from monoloco_tpu.ops import fused_mlp as jf
from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import fused_mlp as tf
from test_torch_layer_kernels import ROWS, SHAPES, _fold, _inputs, _pack_to_torch

F32_ATOL = 1e-5
DYN8_MEAN_REL = 1e-5     # hidden 128
DYN8_ROWS_OFF = 0.05     # hidden 256
MAX_ABS_TOL = 1e-2
VS_F32 = 1.25

CHAINS = {'f32': (tf.layered_f32_forward_plain, tf.fused_forward_plain),
          'dyn8': (tf.layered_dyn8_forward_plain, tf.dyn8_forward_plain)}


@pytest.fixture(scope='module')
def folds():
    return {shape: _fold(*shape) for shape in SHAPES}


def _jax_pack(folded, pack):
    return (jf.pack_folded_weights(folded, dtype=jnp.float32) if pack == 'f32'
            else jf.pack_folded_weights_w8(folded))


@pytest.mark.parametrize('pack', list(CHAINS))
@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_chain_equals_plain_forward_bit_for_bit(folds, pack, hidden, in_dim, out_dim):
    packed = _pack_to_torch(_jax_pack(folds[hidden, in_dim, out_dim], pack))
    chain, whole = CHAINS[pack]
    for m in ROWS:
        x = torch.from_numpy(_inputs(m, in_dim, seed=m))
        out = chain(packed, x)
        assert out.shape == (m, out_dim)
        assert torch.equal(out, whole(packed, x)), m


@pytest.mark.parametrize('pack', list(CHAINS))
@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_chain_matches_jax_interpret(folds, pack, hidden, in_dim, out_dim):
    folded = folds[hidden, in_dim, out_dim]
    jp = _jax_pack(folded, pack)
    x = _inputs(max(ROWS), in_dim, seed=hidden + 3)
    if pack == 'f32':
        ref = jf.fused_loco_forward(None, jnp.asarray(x), packed=jp, tile=128, interpret=True)
    else:
        ref = jf.fused_loco_forward_dyn8(jp, jnp.asarray(x), tile=128, interpret=True)
    ref = np.asarray(ref)
    chain = CHAINS[pack][0](_pack_to_torch(jp), torch.from_numpy(x)).numpy()
    assert chain.shape == ref.shape == (max(ROWS), out_dim)
    # Rows are independent in both, so the prefixes stand for m = 1 and 77.
    for m in ROWS:
        diff = np.abs(chain[:m] - ref[:m])
        if pack == 'f32':
            assert diff.max() <= F32_ATOL, (m, diff.max())
            continue
        assert diff.max() <= MAX_ABS_TOL, (m, diff.max())
        if hidden == 128:
            assert diff.mean() <= DYN8_MEAN_REL * np.abs(ref[:m]).mean(), (m, diff.mean())
        else:
            rows_off = (diff > 1e-5 * (1 + np.abs(ref[:m]))).any(axis=1).mean()
            assert rows_off <= DYN8_ROWS_OFF, (m, rows_off)
    if pack == 'dyn8':
        f32 = np.asarray(jax_folded_forward(folded, x))
        assert np.abs(chain - f32).mean() <= VS_F32 * np.abs(ref - f32).mean()


@pytest.mark.parametrize('scale', [1.0, 1e-20, 1e20])
def test_split_tf32_parts(scale):
    rng = np.random.default_rng(2)
    t = (rng.normal(size=4096) * np.exp(rng.uniform(-8, 8, 4096)) * scale).astype(np.float32)
    # exact ties of the tf32 rounding: the dropped bits are 0x1000
    t[:64] = (np.arange(1, 65, dtype=np.uint32) << 13 | 0x3F801000).view(np.float32)
    t = torch.from_numpy(t)
    big, small = tf.split_tf32_plain(t)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = ((big.double() + small.double()) - t.double()).abs()
    assert bool((err <= 2.0 ** -22 * t.double().abs()).all())
    # ties round away from zero, on both signs
    assert bool((big[:64].abs() > t[:64].abs()).all())
    assert torch.equal(tf.split_tf32_plain(-t)[0], -big)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tf32x3_matmul(a, w):
    """a @ w as a 3xTF32 layer computes it: the big product and the two
    cross products of the tf32 parts in two f32 sums (here exact in float64,
    then rounded), added once; a_small w_small is dropped."""
    (ab, as_), (wb, ws) = tf.split_tf32_plain(a), tf.split_tf32_plain(w)
    big = (ab.double() @ wb.double()).float()
    small = (ab.double() @ ws.double() + as_.double() @ wb.double()).float()
    return big + small


def test_emulated_3xtf32_chain_at_full_width():
    from monoloco_tpu_torch.models import fold_eval_params
    chip_smoke = _chip_smoke()
    params, bn_state = chip_smoke.make_weights()
    packed = tf.pack_folded_weights(fold_eval_params(params, bn_state), torch.float32)
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    assert wstack.shape == (8, 1024, 1024)
    x = chip_smoke.make_inputs(256, 'cpu')
    exact = tf.fused_forward_plain(packed, x)
    emulated = tf._chain(x, tf._f64_matmul,
                         lambda a, i: _tf32x3_matmul(a, wstack[i]) + bstack[i][None, :],
                         wstack.shape[0], w0, b0, waux, baux, wfin, bfin)
    assert float((emulated - exact).abs().max()) <= 1e-5
    assert not torch.equal(emulated, exact)   # the emulation is not the exact product


@pytest.mark.parametrize('hidden', [128, 256])
def test_transposed_stacks_hold_the_same_values(hidden):
    rng = np.random.default_rng(hidden)
    w = torch.from_numpy(rng.normal(size=(3, hidden, hidden)).astype(np.float32))
    wq, _ = ops.quant_weight(w.reshape(3 * hidden, hidden))
    wq = wq.reshape(3, hidden, hidden)
    wt = ops.transpose_int8_plain(wq)
    assert wt.dtype == torch.int8 and wt.is_contiguous()
    assert torch.equal(wt.transpose(-1, -2), wq)
    big, small = ops.transpose_split_plain(w)
    ref_big, ref_small = ops.split_tf32_plain(w)
    assert big.is_contiguous() and small.is_contiguous()
    assert torch.equal(big.transpose(-1, -2), ref_big)
    assert torch.equal(small.transpose(-1, -2), ref_small)


def _layer_inputs(hidden=128, m=40, seed=0):
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    act[3] = 0.0                                          # the 1e-8 guard of an all-zero row
    w = torch.from_numpy((rng.normal(size=(hidden, hidden)) / hidden ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    return act, w, b, y


def test_dyn8_layer_is_the_dynamic_layer_bit_for_bit():
    """quantize_rows_plain then s8_layer_plain, per epilogue, against the
    whole-forward plain layer `_dynamic_layer`."""
    act, w, b, y = _layer_inputs(seed=1)
    wq, oscale = ops.quant_weight(w)
    v = tf._dynamic_layer(act, wq, oscale, b)
    q, s_row = ops.quantize_rows_plain(act)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127 and int(q[3].abs().max()) == 0
    wt = ops.transpose_int8_plain(wq)
    for epilogue, ref in (('store', v), ('relu', torch.relu(v))):
        out, out_bf = ops.s8_layer_plain(q, s_row, wt, oscale, b, epilogue)
        assert torch.equal(out, ref) and torch.equal(out_bf, ref.to(torch.bfloat16))
    y0 = y.clone()
    out, _ = ops.s8_layer_plain(q, s_row, wt, oscale, b, 'add_relu', y)
    assert out is y and torch.equal(y, y0 + torch.relu(v))


def test_f32_layer_epilogues():
    act, w, b, y = _layer_inputs(seed=2)
    v = (act.double() @ w.double()).float() + b[None, :]
    assert torch.equal(ops.f32_layer_plain(act, w, b, 'store'), v)
    assert torch.equal(ops.f32_layer_plain(act, w, b, 'relu'), torch.relu(v))
    y0 = y.clone()
    assert ops.f32_layer_plain(act, w, b, 'add_relu', y) is y
    assert torch.equal(y, y0 + torch.relu(v))
    emulated = _tf32x3_matmul(act, w) + b[None, :]
    assert float(((emulated - v).abs() / (1 + v.abs())).max()) <= 1e-6


def test_layer_entries_run_plain_on_cpu_and_refuse_what_they_cannot_take():
    act, w, b, y = _layer_inputs(seed=3)
    wq, oscale = ops.quant_weight(w)
    before = dict(ops.launches)
    for epilogue in ('store', 'relu', 'add_relu'):
        y_k, y_p = y.clone(), y.clone()
        assert torch.equal(ops.loco_layer_f32(act, w, b, epilogue, y_k),
                           ops.f32_layer_plain(act, w, b, epilogue, y_p))
        assert torch.equal(y_k, y_p)
        y_k, y_p = y.clone(), y.clone()
        out, out_bf = ops.loco_layer_dyn8(act, wq, oscale, b, epilogue, y_k)
        ref, ref_bf = ops.s8_layer_plain(*ops.quantize_rows_plain(act),
                                         ops.transpose_int8_plain(wq), oscale, b, epilogue, y_p)
        assert torch.equal(out, ref) and torch.equal(out_bf, ref_bf) and torch.equal(y_k, y_p)
    assert ops.launches == before
    for entry, args in ((ops.loco_layer_f32, (w, b)), (ops.loco_layer_dyn8, (wq, oscale, b))):
        with pytest.raises(ValueError, match='residual'):
            entry(act, *args, 'add_relu')
        with pytest.raises(ValueError, match='epilogue'):
            entry(act, *args, 'gelu')
        with pytest.raises(ValueError, match='hidden % 128'):
            entry(act[:, :96], *args, 'relu')
        with pytest.raises(ValueError, match='no path'):
            entry(act.to('meta'), *args, 'relu')
