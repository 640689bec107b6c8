"""The port's static int8 quantization (ops/quant.py) against the JAX
package's `monoloco_tpu/ops/quant.py`.

Both sides take the same folded weights (the JAX fold with perturbed BN, as
numpy; hidden 128, 3 stages) and inputs from a numpy seed. Weight
quantization is exact. The calibration replays the f32 forward in each
framework's sum order, so the activation scales agree to rtol 1e-6. The
int8 forward quantizes with identical float operations and sums integers
exactly, so on the same scales it agrees to f32 rounding (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import fold_eval_params as jax_fold
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.ops import quant as jq
from monoloco_tpu_torch.ops import quant as tq

SCALE_RTOL = 1e-6


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


@pytest.fixture(scope='module')
def folded():
    params, bn = jax_init(jax.random.PRNGKey(0), 34, 9, 128, 3)
    rng = np.random.default_rng(0)
    bn = jax.tree_util.tree_map(np.array, bn)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = rng.normal(0, 0.1, s['mean'].shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, s['var'].shape).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax_fold(params, bn))


@pytest.fixture(scope='module')
def calib():
    return np.random.default_rng(9).normal(size=(512, 34)).astype(np.float32)


@pytest.fixture(scope='module')
def both_q(folded, calib):
    return (jq.quantize_folded(folded, jnp.asarray(calib)),
            tq.quantize_folded(_to_torch(folded), torch.from_numpy(calib)))


def test_synthetic_calibration_inputs_match_jax():
    ours = tq.synthetic_calibration_inputs(34, n=64).numpy()
    ref = np.asarray(jq.synthetic_calibration_inputs(34, n=64))
    assert ours.shape == (64, 34)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours, tq.synthetic_calibration_inputs(34, n=64).numpy())


def test_synthetic_calibration_inputs_stereo_waits_for_its_slice():
    """The stereo slice is in: the 68-input batch is the JAX package's, the
    8 x 8 all-vs-all pairing of its draws."""
    ours = tq.synthetic_calibration_inputs(68, n=64).numpy()
    ref = np.asarray(jq.synthetic_calibration_inputs(68, n=64))
    assert ours.shape == ref.shape == (64, 68)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_int8_dense_exact_on_integer_grid():
    """Integer weights with column max 127 and integer activations at scale
    1 quantize losslessly, so the int8 layer is the exact product."""
    rng = np.random.RandomState(0)
    w = rng.randint(-127, 128, (8, 4)).astype(np.float32)
    w[0, :] = 127.0
    x = rng.randint(-127, 128, (5, 8)).astype(np.float32)
    wq, scale = tq.quant_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(scale.numpy(), np.ones(4))
    out = tq._int8_dense(torch.from_numpy(x), torch.tensor(1.0),
                         {'wq': wq, 'scale': scale, 'b': torch.zeros(4)})
    np.testing.assert_array_equal(out.numpy(), x @ w)


def test_quantize_folded_matches_jax(both_q):
    jqd, tqd = both_q
    flat_j = jax.tree_util.tree_flatten_with_path(jqd)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tqd))[0])
    assert len(flat_j) == len(flat_t)
    for path, ref in flat_j:
        ours = flat_t[path]
        ref = np.asarray(ref)
        name = jax.tree_util.keystr(path)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
        if name.endswith("_in']") or name.endswith("_out']"):
            np.testing.assert_allclose(ours, ref, rtol=SCALE_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=name)
    assert tqd['stages']['a']['wq'].dtype == torch.int8
    assert tqd['stages']['a']['wq'].shape == (3, 128, 128)


@pytest.mark.parametrize('m', [77, 256])
def test_quantized_forward_matches_jax(folded, calib, both_q, m):
    jqd, tqd = both_q
    x = calib[:m]
    ref = np.asarray(jq.quantized_forward(jqd, jnp.asarray(x)))
    ours = tq.quantized_forward(tqd, torch.from_numpy(x)).numpy()
    assert ours.shape == (m, 9)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    # On the JAX package's own scales, too.
    ours_on_jax_q = tq.quantized_forward(_to_torch(jqd), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours_on_jax_q, ref, rtol=1e-6, atol=1e-6)


def test_wide_layers_sum_exactly():
    """Above K = 1040 an f32 sum of s8 x s8 products can round; the port
    switches to float64 there and stays exact."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-127, 128, (4, 2048)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (2048, 3)).astype(np.int8))
    exact = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    np.testing.assert_array_equal(tq._int8_matmul(xq, wq).numpy(), exact.astype(np.float32))
