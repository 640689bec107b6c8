"""The layered forward of K1-bf16 and K5 (`csrc/wgmma_layer.cu`), launch by
launch, on the CPU: the plain versions of its launches (input projection,
H x H layer with each epilogue, heads) chained as the kernels chain them.

- Bit for bit, the chain equals the plain versions of the whole forward,
  `fused_forward_plain` (bf16 pack) and `w8_forward_plain` (w8 pack): the
  kernels' split into launches changes no float operation, since every
  consumer of an activation but the residual rounds it to bf16 first and
  bf16(relu(v)) == relu(bf16(v)).
- Against the JAX package's Pallas kernels in interpret mode, on the JAX
  package's own packs. Both round to bf16 at the same points (checked stage
  by stage: a jnp replica of the `_kernel` body equals the interpret output
  bit for bit, and its products and casts are the chain's). They differ in
  how a dot's f32 sum is ordered: the plain versions sum in float64 and
  round once, XLA:CPU sums in f32 in an order that depends on the CPU (its
  bf16 dots differ from the exact sum in 17-69% of the outputs, by less
  than an f32 ulp of the mean on average; tests/torch_sum_order_probe.py).
  A different f32 sum can flip a later bf16 rounding, and one flip moves
  that activation by a whole bf16 ulp. So the mean
  error is held to a worst-case bound derived from that arithmetic
  (`_sum_order_bound`), not to a value read off one machine; the max to
  1e-2, and the chain is no further from the f32 MLP than 1.25x the Pallas
  kernel is. `test_sum_order_bound_catches_faults` shows that the bound
  still fails a chain with a seeded fault.

Weights: the JAX fold with perturbed BN statistics, 3 stages, hidden 128
and 256, 34 -> 9 and 68 -> 10; inputs from a numpy seed, m = 1, 77, 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import fold_eval_params as jax_fold
from monoloco_tpu.models import folded_forward as jax_folded_forward
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.ops import fused_mlp as jf
from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import fused_mlp as tf

MAX_ABS_TOL = 1e-2
VS_F32 = 1.25
ROWS = (1, 77, 256)
SHAPES = [(128, 34, 9), (128, 68, 10), (256, 34, 9), (256, 68, 10)]


def _fold(hidden, in_dim, out_dim):
    """As tests/test_torch_fused_mlp_family.py folds: key and seed 0 for
    34 -> 9, 3 for 68 -> 10."""
    key = 0 if in_dim == 34 else 3
    params, bn = jax_init(jax.random.PRNGKey(key), in_dim, out_dim, hidden, 3)
    rng = np.random.default_rng(key)
    bn = jax.tree_util.tree_map(np.array, bn)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = rng.normal(0, 0.1, s['mean'].shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, s['var'].shape).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax_fold(params, bn))


def _jax_pack(folded, pack):
    return (jf.pack_folded_weights(folded, dtype=jnp.bfloat16) if pack == 'bf16'
            else jf.pack_folded_weights_w8(folded))


def _pack_to_torch(packed):
    """A JAX pack as torch tensors of the same dtypes (bf16 through f32)."""
    return tuple(torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                 if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))
                 for a in packed)


def _inputs(m, in_dim, seed):
    return np.random.default_rng(seed).normal(size=(m, in_dim)).astype(np.float32)


@pytest.fixture(scope='module')
def folds():
    return {shape: _fold(*shape) for shape in SHAPES}


@pytest.mark.parametrize('pack', ['bf16', 'w8'])
@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_layer_chain_equals_plain_forward_bit_for_bit(folds, pack, hidden, in_dim, out_dim):
    packed = _pack_to_torch(_jax_pack(folds[hidden, in_dim, out_dim], pack))
    whole = tf.fused_forward_plain if pack == 'bf16' else tf.w8_forward_plain
    for m in ROWS:
        x = torch.from_numpy(_inputs(m, in_dim, seed=m))
        chain = tf.layered_forward_plain(packed, x)
        assert chain.shape == (m, out_dim)
        assert torch.equal(chain, whole(packed, x)), m


F32_U = 2.0 ** -24    # unit roundoff of f32


def _f32_sum_error(a, w, bias, oscale=None):
    """Worst-case gap between two f32 evaluations of bf16(a) @ w (times the
    column scale of a w8 pack) + bias, in float64: any order of a K-term
    sum of exact products is within gamma_(K-1) * sum |a_k w_k| of the
    exact sum (gamma_n = n u / (1 - n u)), the plain version's is within u
    of it, and the scale's product and the bias's sum each add u of their
    result on each side."""
    k = w.shape[0]
    mags = a.to(torch.bfloat16).double().abs() @ w.double().abs()
    if oscale is not None:
        mags = mags * oscale.double().abs()[None, :]
    gamma = (k - 1) * F32_U / (1 - (k - 1) * F32_U)
    return (gamma + 5 * F32_U) * mags + 2 * F32_U * bias.double().abs()[None, :]


def _bf16_flip(v):
    """(gap, margin) of each f32 value of v: the gap between its two bf16
    neighbours, and its distance from their midpoint, where rounding to
    bf16 flips."""
    bits = v.contiguous().view(torch.int32) & ~0xFFFF
    lo = bits.view(torch.float32).double()
    hi = (bits + 0x10000).view(torch.float32).double()
    return (hi - lo).abs(), (v.double() - (hi + lo) / 2).abs()


def _sum_order_bound(packed, x, with_share=False):
    """Worst-case |chain - kernel| per output, (m, out) float64, for two
    forwards that round to bf16 at the same points and differ only in the
    order of each dot's f32 sum.

    Each dot of either side is within e = `_f32_sum_error` of the exact sum.
    An f32 value then rounded to bf16 can round the other way on the other
    side only if it lies within its e of a bf16 midpoint; such a flip moves
    that activation by its bf16 gap g, and every output o by g * |d o / d a|
    to first order. A value that cannot flip rounds alike on both sides and
    moves nothing. The f32 residual y carries the e of each layer added into
    it, and the heads' own e lands on the outputs directly. So the bound is
    sum over flippable roundings of g * |d o / d a|, plus the heads' e,
    with d o / d a taken by autograd through the chain in float64, the relu
    masks those of the plain versions and each bf16 rounding passed
    straight through. With `with_share`, also the share of the roundings
    that can flip (tests/torch_sum_order_probe.py prints it and how much of
    the bound the chain uses)."""
    w0, b0, wstack, bstack, oscale, waux, baux, wfin, bfin = tf._layered_args(packed)
    n_mm = wstack.shape[0]
    osc = [None if oscale is None else oscale[i] for i in range(n_mm)]
    taps = []      # (zero tensor whose gradient is d out / d a, f32 value, its e)

    def rounded(v32, err, v64):
        tap = torch.zeros_like(v64, requires_grad=True)
        taps.append((tap, v32, err))
        return v64 + (v32.to(torch.bfloat16).double() - v64).detach() + tap

    def layer(a32, a64, i):
        v64 = a64 @ wstack[i].double()
        if osc[i] is not None:
            v64 = v64 * osc[i].double()[None, :]
        v64 = v64 + bstack[i].double()[None, :]
        return v64, v64.detach().float(), _f32_sum_error(a32, wstack[i], bstack[i], osc[i])

    y32, _ = tf.input_projection_plain(x, w0, b0)
    v64 = x.to(torch.bfloat16).double() @ w0.double() + b0.double()[None, :]
    y64, y_err = torch.relu(v64), _f32_sum_error(x, w0, b0) * (v64 > 0)
    for i in range(0, n_mm - 2, 2):
        va, va32, ea = layer(y32, rounded(y32, y_err, y64), i)
        h32 = torch.relu(va32)
        vb, vb32, eb = layer(h32, rounded(h32, ea * (va > 0), torch.relu(va)), i + 1)
        y64, y32, y_err = y64 + torch.relu(vb), y32 + torch.relu(vb32), y_err + eb * (vb > 0)
    v2, v2_32, e2 = layer(y32, rounded(y32, y_err, y64), n_mm - 2)
    y2 = rounded(v2_32, e2, v2)
    v3, v3_32, e3 = layer(v2_32, y2, n_mm - 1)
    y3_32 = torch.relu(v3_32)
    y3 = rounded(y3_32, e3 * (v3 > 0), torch.relu(v3))
    out = torch.cat([y3 @ wfin.double() + bfin.double()[None, :],
                     y2 @ waux.double() + baux.double()[None, :]], dim=1)
    bound = torch.cat([_f32_sum_error(y3_32, wfin, bfin), _f32_sum_error(v2_32, waux, baux)],
                      dim=1)
    flips = [(_bf16_flip(v32), err) for _, v32, err in taps]
    for o in range(out.shape[1]):
        grads = torch.autograd.grad(out[:, o].sum(), [t for t, _, _ in taps], retain_graph=True)
        for grad, ((gap, margin), err) in zip(grads, flips):
            bound[:, o] += ((margin <= err) * gap * grad.abs()).sum(dim=1)
    if not with_share:
        return bound.numpy()
    can = sum(int((margin <= err).sum()) for (_, margin), err in flips)
    return bound.numpy(), can / sum(err.numel() for _, err in flips)


def _assert_within_sum_order_bound(chain, ref, bound):
    # Rows are independent in both, so the prefixes stand for m = 1 and 77.
    for m in ROWS:
        diff = np.abs(chain[:m] - ref[:m])
        assert diff.mean() <= bound[:m].mean(), (m, diff.mean(), bound[:m].mean())
        assert diff.max() <= MAX_ABS_TOL, (m, diff.max())


def _jax_entry(jp, pack):
    return ((lambda v: jf.fused_loco_forward(None, v, packed=jp, tile=128, interpret=True))
            if pack == 'bf16' else
            (lambda v: jf.fused_loco_forward_w8(jp, v, tile=128, interpret=True)))


@pytest.mark.parametrize('pack', ['bf16', 'w8'])
@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_layer_chain_matches_jax_interpret(folds, pack, hidden, in_dim, out_dim):
    folded = folds[hidden, in_dim, out_dim]
    jp = _jax_pack(folded, pack)
    x = _inputs(max(ROWS), in_dim, seed=hidden + 3)
    ref = np.asarray(_jax_entry(jp, pack)(jnp.asarray(x)))
    packed = _pack_to_torch(jp)
    chain = tf.layered_forward_plain(packed, torch.from_numpy(x)).numpy()
    assert chain.shape == ref.shape == (max(ROWS), out_dim)
    _assert_within_sum_order_bound(chain, ref, _sum_order_bound(packed, torch.from_numpy(x)))
    f32 = np.asarray(jax_folded_forward(folded, x))
    assert np.abs(chain - f32).mean() <= VS_F32 * np.abs(ref - f32).mean()


def _faulty_chain(packed, x, fault):
    """`layered_forward_plain` with one seeded fault."""
    w0, b0, wstack, bstack, oscale, waux, baux, wfin, bfin = tf._layered_args(packed)
    y, first = tf.input_projection_plain(x, w0, torch.zeros_like(b0) if fault == 'input_bias'
                                         else b0)
    bufs = [first, None]
    for i, src, dst, epilogue in tf._layer_schedule(wstack.shape[0]):
        if fault == 'residual' and i == 1:
            y.zero_()          # stage 0 keeps h and drops y + h
        bufs[dst] = tf.layer_plain(bufs[src], wstack[i], bstack[i], epilogue,
                                   None if oscale is None else oscale[i], y)
    out = tf.heads_plain(bufs[1], bufs[0], waux, baux, wfin, bfin)
    return out[:, [1, 0, *range(2, out.shape[1])]] if fault == 'head_swap' else out


@pytest.mark.parametrize('fault', ['none', 'residual', 'head_swap', 'input_bias'])
def test_sum_order_bound_catches_faults(folds, fault):
    """The derived bound at the shape that failed the measured one (hidden
    128, 68 -> 10, bf16): the chain passes, and a dropped residual add, two
    head columns swapped or the input projection's bias left out fail it."""
    jp = _jax_pack(folds[128, 68, 10], 'bf16')
    x = _inputs(max(ROWS), 68, seed=128 + 3)
    ref = np.asarray(_jax_entry(jp, 'bf16')(jnp.asarray(x)))
    packed = _pack_to_torch(jp)
    bound = _sum_order_bound(packed, torch.from_numpy(x))
    chain = _faulty_chain(packed, torch.from_numpy(x), fault).numpy()
    if fault == 'none':
        assert np.array_equal(chain, tf.layered_forward_plain(packed, torch.from_numpy(x)).numpy())
        _assert_within_sum_order_bound(chain, ref, bound)
        return
    with pytest.raises(AssertionError):
        _assert_within_sum_order_bound(chain, ref, bound)
    # the mean bound alone fails it, over all rows, by a wide margin
    assert np.abs(chain - ref).mean() > 10 * bound.mean()


def _layer_inputs(hidden=128, m=40, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(hidden, hidden)) / hidden ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    return a, w, b, y


@pytest.mark.parametrize('w8', [False, True])
def test_layer_epilogues(w8):
    """store = bf16(v), relu = bf16(relu(v)) = relu(bf16(v)), add_relu adds
    relu(v) to the f32 residual in place and returns bf16 of it; v is
    a @ w + b, or (a @ wq) * oscale + b for int8 weights."""
    a, w, b, y = _layer_inputs(seed=int(w8))
    if w8:
        wq, oscale = ops.quant_weight(w)
        v = (a.double() @ wq.double()).float() * oscale[None, :] + b[None, :]
        args = (wq, b)
    else:
        oscale = None
        wb = w.to(torch.bfloat16)
        v = (a.double() @ wb.double()).float() + b[None, :]
        args = (wb, b)
    store = ops.layer_plain(a, *args, 'store', oscale)
    relu = ops.layer_plain(a, *args, 'relu', oscale)
    assert store.dtype == relu.dtype == torch.bfloat16
    assert torch.equal(store, v.to(torch.bfloat16))
    assert torch.equal(relu, torch.relu(v).to(torch.bfloat16))
    assert torch.equal(relu, torch.relu(store))
    y0 = y.clone()
    out = ops.layer_plain(a, *args, 'add_relu', oscale, y)
    assert torch.equal(y, y0 + torch.relu(v))
    assert torch.equal(out, y.to(torch.bfloat16))


def test_input_projection_and_heads():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(9, 34)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(34, 128)).astype(np.float32)).to(torch.bfloat16)
    b0 = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    y, ybf = ops.input_projection_plain(x, w0, b0)
    ref = torch.relu((x.to(torch.bfloat16).double() @ w0.double()).float() + b0)
    assert torch.equal(y, ref) and torch.equal(ybf, ref.to(torch.bfloat16))
    y2, y3 = ybf, torch.relu(ybf - 0.5)
    waux, wfin = w0[1:2].T.contiguous(), w0[2:10].T.contiguous()
    baux, bfin = b0[:1], b0[1:9]
    out = ops.heads_plain(y2, y3, waux, baux, wfin, bfin)
    assert out.shape == (9, 9)
    assert torch.equal(out[:, :8], (y3.double() @ wfin.double()).float() + bfin)
    assert torch.equal(out[:, 8:], (y2.double() @ waux.double()).float() + baux)


def test_loco_layer_runs_plain_on_cpu_and_refuses_what_it_cannot_take():
    a, w, b, y = _layer_inputs()
    wb = w.to(torch.bfloat16)
    before = dict(ops.launches)
    for epilogue in ('store', 'relu', 'add_relu'):
        y_k, y_p = y.clone(), y.clone()
        assert torch.equal(ops.loco_layer(a, wb, b, epilogue, y=y_k),
                           ops.layer_plain(a, wb, b, epilogue, y=y_p))
        assert torch.equal(y_k, y_p)
    assert ops.launches == before
    with pytest.raises(ValueError, match='residual'):
        ops.loco_layer(a, wb, b, 'add_relu')
    with pytest.raises(ValueError, match='epilogue'):
        ops.loco_layer(a, wb, b, 'gelu')
    with pytest.raises(ValueError, match='hidden % 128'):
        ops.loco_layer(a[:, :96], wb[:96, :96], b[:96], 'relu')
    with pytest.raises(ValueError, match='no path'):
        ops.loco_layer(a.to('meta'), wb.to('meta'), b.to('meta'), 'relu')
