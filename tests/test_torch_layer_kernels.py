"""The layered forward of K1-bf16 and K5 (`csrc/wgmma_layer.cu`), launch by
launch, on the CPU: the plain versions of its launches (input projection,
H x H layer with each epilogue, heads) chained as the kernels chain them.

- Bit for bit, the chain equals the plain versions of the whole forward,
  `fused_forward_plain` (bf16 pack) and `w8_forward_plain` (w8 pack): the
  kernels' split into launches changes no float operation, since every
  consumer of an activation but the residual rounds it to bf16 first and
  bf16(relu(v)) == relu(bf16(v)).
- Against the JAX package's Pallas kernels in interpret mode, on the JAX
  package's own packs. The plain versions sum in float64 where the Pallas
  kernels sum in f32, which can flip a bf16 rounding of a later layer. At
  hidden 128 the tolerance is that of tests/test_torch_fused_mlp_family.py:
  mean error 1e-5 of the mean output, max 1e-2. At hidden 256 a row holds
  twice the roundings, each behind a sum twice as long, and the mean error
  reached 3.1e-5 of the mean output over three input seeds for each pack
  and input width; it is held to 4e-5, the max to 1e-2. In both, the chain is no further from the f32
  MLP than 1.25x the Pallas kernel is, which a wrong chain cannot meet.

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

MEAN_REL_TOL = {128: 1e-5, 256: 4e-5}
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


@pytest.mark.parametrize('pack', ['bf16', 'w8'])
@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_layer_chain_matches_jax_interpret(folds, pack, hidden, in_dim, out_dim):
    folded = folds[hidden, in_dim, out_dim]
    jp = _jax_pack(folded, pack)
    x = _inputs(max(ROWS), in_dim, seed=hidden + 3)
    entry = ((lambda v: jf.fused_loco_forward(None, v, packed=jp, tile=128, interpret=True))
             if pack == 'bf16' else
             (lambda v: jf.fused_loco_forward_w8(jp, v, tile=128, interpret=True)))
    ref = np.asarray(entry(jnp.asarray(x)))
    chain = tf.layered_forward_plain(_pack_to_torch(jp), torch.from_numpy(x)).numpy()
    assert chain.shape == ref.shape == (max(ROWS), out_dim)
    # Rows are independent in both, so the prefixes stand for m = 1 and 77.
    for m in ROWS:
        diff = np.abs(chain[:m] - ref[:m])
        assert diff.mean() <= MEAN_REL_TOL[hidden] * np.abs(ref[:m]).mean(), (m, diff.mean())
        assert diff.max() <= MAX_ABS_TOL, (m, diff.max())
    f32 = np.asarray(jax_folded_forward(folded, x))
    assert np.abs(chain - f32).mean() <= VS_F32 * np.abs(ref - f32).mean()


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
