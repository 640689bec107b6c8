"""The layered forward of K4, static a8w8 (`csrc/wgmma_layer_kmajor.cu`'s
static s8 layers with the input projection and heads of
`csrc/wgmma_layer.cu`), launch by launch, on the CPU: the plain versions of
its launches chained as the kernels chain them.

- Bit for bit, the chain equals `int8_static_forward_plain`: moving each
  layer's quantization into the previous layer's epilogue changes no float
  operation.
- Against the JAX package's Pallas kernel in interpret mode, on the JAX
  package's own pack (`pack_folded_weights_int8`), under
  tests/test_torch_fused_mlp_family.py's rule: mean error 1e-5 of the mean
  output, max 1e-2. The plain version sums the bf16 input projection in
  float64 where the Pallas kernel sums in f32, and a last-ulp difference
  there can flip a quantization tie.
- One static layer per epilogue is the whole forward's layer (`_static_layer`)
  followed by the next layer's quantization, bit for bit; the quantization
  rounds ties half to even and clips beyond +-127.
- `loco_layer_static` runs the plain layer on the CPU, counts no launch and
  refuses what the kernel cannot take.

Weights: the JAX fold with perturbed BN statistics, 3 stages, hidden 128
and 256, 34 -> 9 and 68 -> 10; calibration and inputs from a numpy seed,
m = 1, 77, 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.ops import fused_mlp as jf
from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import fused_mlp as tf
from test_torch_layer_kernels import ROWS, SHAPES, _fold, _inputs, _pack_to_torch

MEAN_REL_TOL = 1e-5
MAX_ABS_TOL = 1e-2
EPILOGUES = ['store', 'relu', 'add_relu']


@pytest.fixture(scope='module')
def packs():
    """shape -> the JAX package's static pack, calibrated on 512 rows."""
    return {shape: jf.pack_folded_weights_int8(_fold(*shape),
                                               jnp.asarray(_inputs(512, shape[1], seed=9)))
            for shape in SHAPES}


@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_chain_equals_plain_forward_bit_for_bit(packs, hidden, in_dim, out_dim):
    packed = _pack_to_torch(packs[hidden, in_dim, out_dim])
    assert packed[2].dtype == torch.int8 and packed[3].shape == (8,)
    for m in ROWS:
        x = torch.from_numpy(_inputs(m, in_dim, seed=m))
        out = ops.layered_static_forward_plain(packed, x)
        assert out.shape == (m, out_dim)
        assert torch.equal(out, ops.int8_static_forward_plain(packed, x)), m


@pytest.mark.parametrize('hidden,in_dim,out_dim', SHAPES)
def test_chain_matches_jax_interpret(packs, hidden, in_dim, out_dim):
    jp = packs[hidden, in_dim, out_dim]
    x = _inputs(max(ROWS), in_dim, seed=hidden + 3)
    ref = np.asarray(jf.fused_loco_forward_int8(jp, jnp.asarray(x), tile=128, interpret=True))
    chain = ops.layered_static_forward_plain(_pack_to_torch(jp), torch.from_numpy(x)).numpy()
    assert chain.shape == ref.shape == (max(ROWS), out_dim)
    # Rows are independent in both, so the prefixes stand for m = 1 and 77.
    for m in ROWS:
        diff = np.abs(chain[:m] - ref[:m])
        assert diff.mean() <= MEAN_REL_TOL * np.abs(ref[:m]).mean(), (m, diff.mean())
        assert diff.max() <= MAX_ABS_TOL, (m, diff.max())


def _layer_inputs(hidden=128, m=40, seed=0):
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(hidden, hidden)) / hidden ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    return act, w, b, y


def _static_operands(seed):
    """A layer's input, int8 weights, scales as pack_folded_weights_int8
    makes them (inv_in = 1 / s_in, oscale = s_in x the weight column scale),
    bias and residual."""
    act, w, b, y = _layer_inputs(seed=seed)
    wq, wscale = ops.quant_weight(w)
    s_in = torch.tensor(3.0 / 127.0)           # clips the 0.3% of |act| above 3
    return act, wq, torch.ones(()) / s_in, s_in * wscale, b, y


@pytest.mark.parametrize('epilogue', EPILOGUES)
def test_static_layer_is_the_whole_forward_layer_then_the_next_quantization(epilogue):
    act, wq, inv_in, oscale, b, y = _static_operands(seed=1)
    v = tf._static_layer(act, wq, inv_in, oscale, b)
    ref = {'store': v, 'relu': torch.relu(v), 'add_relu': y + torch.relu(v)}[epilogue]
    inv_next = torch.full((), 127.0) / (0.5 * ref.abs().max())   # clips the largest outputs
    q = ops.quantize_static_plain(act, inv_in)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    y_k = y.clone()
    out, out_bf, q_next = ops.static_s8_layer_plain(q, ops.transpose_int8_plain(wq), oscale, b,
                                                     epilogue, inv_next, y_k)
    assert torch.equal(out, ref) and torch.equal(out_bf, ref.to(torch.bfloat16))
    assert (out is y_k) == (epilogue == 'add_relu')
    # The next layer of the whole forward quantizes ref the same way.
    assert q_next.dtype == torch.int8
    assert torch.equal(q_next.double(), torch.clamp(torch.round(ref * inv_next), -127, 127).double())
    assert int(q_next.abs().max()) == 127
    assert ops.static_s8_layer_plain(q, ops.transpose_int8_plain(wq), oscale, b, epilogue,
                                     y=y.clone())[2] is None


def test_static_quantization_rounds_ties_to_even_and_clips():
    act = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5, 200.0, -200.0,
                        1e30, -1e30, 0.49999997, 3.0])
    want = torch.tensor([0, 2, 2, 0, -2, -2, 126, 127, -127, 127, -127, 127, -127, 0, 3],
                        dtype=torch.int8)
    assert torch.equal(ops.quantize_static_plain(act, torch.ones(())), want)
    # the product act * inv is rounded to f32 first, then to an integer
    assert torch.equal(ops.quantize_static_plain(act * 2, torch.tensor(0.5)), want)


def test_static_input_projection_quantizes_y_for_the_first_layer():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(9, 34)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(34, 128)).astype(np.float32)).to(torch.bfloat16)
    b0 = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    inv0 = torch.tensor(127.0 / 4.0)
    y, q0 = ops.static_input_plain(x, w0, b0, inv0)
    ref, _ = ops.input_projection_plain(x, w0, b0)
    assert torch.equal(y, ref) and torch.equal(q0, ops.quantize_static_plain(ref, inv0))
    assert q0.dtype == torch.int8 and int(q0.max()) == 127 and int(q0.min()) == 0


def test_loco_layer_static_runs_plain_on_cpu_and_refuses_what_it_cannot_take():
    act, wq, inv_in, oscale, b, y = _static_operands(seed=2)
    q = ops.quantize_static_plain(act, inv_in)
    inv_next = torch.tensor([20.0])
    before = dict(ops.launches)
    for epilogue in EPILOGUES:
        y_k, y_p = y.clone(), y.clone()
        got = ops.loco_layer_static(q, wq, oscale, b, epilogue, inv_next, y_k)
        ref = ops.static_s8_layer_plain(q, ops.transpose_int8_plain(wq), oscale, b, epilogue,
                                        inv_next, y_p)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)) and torch.equal(y_k, y_p)
        assert ops.loco_layer_static(q, wq, oscale, b, epilogue, y=y.clone())[2] is None
    assert ops.launches == before
    with pytest.raises(ValueError, match='dtype'):
        ops.loco_layer_static(act, wq, oscale, b, 'relu')
    with pytest.raises(ValueError, match='dtype'):
        ops.loco_layer_static(q, wq.float(), oscale, b, 'relu')
    with pytest.raises(ValueError, match='shape'):
        ops.loco_layer_static(q, wq[:, :64].contiguous(), oscale, b, 'relu')
    with pytest.raises(ValueError, match='shape'):
        ops.loco_layer_static(q, wq, oscale[:64], b, 'relu')
    with pytest.raises(ValueError, match='inv_next'):
        ops.loco_layer_static(q, wq, oscale, b, 'relu', torch.ones(2))
    with pytest.raises(ValueError, match='inv_next'):
        ops.loco_layer_static(q, wq, oscale, b, 'relu', torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match='residual'):
        ops.loco_layer_static(q, wq, oscale, b, 'add_relu')
    with pytest.raises(ValueError, match='epilogue'):
        ops.loco_layer_static(q, wq, oscale, b, 'gelu')
    with pytest.raises(ValueError, match='hidden % 128'):
        ops.loco_layer_static(q[:, :96], wq, oscale, b, 'relu')
    with pytest.raises(ValueError, match='no path'):
        ops.loco_layer_static(q.to('meta'), wq, oscale, b, 'relu')
