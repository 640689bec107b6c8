"""The port's dyn8 MLP against the JAX package's Pallas dyn8 kernels.

On the CPU the wrappers run the plain PyTorch version, which is held here
against `fused_loco_forward_dyn8` / `_resident` in Pallas interpret mode on
the same packed weights (hidden 128, 3 stages, inputs from a numpy seed).
Both quantize with identical float operations; they differ in the order of
the f32 sums of the bf16 layers (the plain version sums exactly in float64),
and a last-ulp difference there can flip one quantization tie. So the mean
error is bounded tightly (1e-5 of the mean output) and the max loosely
(1e-2). Packing is exact.

The CUDA kernel itself is tested against the plain version in
tests/test_torch_kernels_cuda.py, which needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import fold_eval_params as jax_fold, folded_forward as jax_folded_forward
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.ops import (fused_loco_forward_dyn8 as jax_dyn8,
                              fused_loco_forward_dyn8_resident as jax_dyn8_resident,
                              pack_folded_weights_w8 as jax_pack)
from monoloco_tpu.ops.quant import _quant_weight as jax_quant_weight
from monoloco_tpu_torch import ops
from monoloco_tpu_torch.models import folded_forward
from monoloco_tpu_torch.ops import (dyn8_forward_plain, dyn8_resident_eligible,
                                    fused_loco_forward_dyn8, fused_loco_forward_dyn8_auto,
                                    fused_loco_forward_dyn8_resident,
                                    pack_folded_weights_w8, quant_weight)

MEAN_REL_TOL = 1e-5
MAX_ABS_TOL = 1e-2


def _tree_to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


@pytest.fixture(scope='module')
def folded():
    """The JAX fold (perturbed BN) as numpy, shared by both packers."""
    params, bn = jax_init(jax.random.PRNGKey(0), 34, 9, 128, 3)
    rng = np.random.default_rng(0)
    bn = jax.tree_util.tree_map(np.array, bn)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = rng.normal(0, 0.1, s['mean'].shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, s['var'].shape).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax_fold(params, bn))


@pytest.fixture(scope='module')
def packs(folded):
    return jax_pack(folded), pack_folded_weights_w8(_tree_to_torch(folded))


def _inputs(m, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(m, 34)) * scale).astype(np.float32)


def _assert_close(ours, ref):
    diff = np.abs(ours - ref)
    assert diff.mean() <= MEAN_REL_TOL * np.abs(ref).mean(), diff.mean()
    assert diff.max() <= MAX_ABS_TOL, diff.max()


def test_quant_weight_matches_jax_exactly():
    w = np.random.default_rng(3).normal(size=(128, 96)).astype(np.float32)
    w[:, 5] = 0.0                                   # zero-column guard
    w[0, 7] = 2.5 * np.abs(w[:, 7]).max()           # a clear column max
    jq, js = jax_quant_weight(jnp.asarray(w))
    tq, ts = quant_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and int(tq[0, 7]) == 127


def test_pack_matches_jax_exactly(packs):
    jp, tp = packs
    assert len(jp) == len(tp) == 10
    for i, (a, b) in enumerate(zip(jp, tp)):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f'packed[{i}]')
    assert tp[2].dtype == torch.int8 and tp[2].shape == (8, 128, 128)
    assert tp[0].dtype == torch.bfloat16 and tp[8].shape == (128, 8)
    assert dyn8_resident_eligible(tp)


@pytest.mark.parametrize('m', [77, 256])
def test_plain_matches_jax_streaming_and_resident(packs, m):
    jp, tp = packs
    x = _inputs(m)
    ours = fused_loco_forward_dyn8(tp, torch.from_numpy(x)).numpy()
    assert ours.shape == (m, 9)
    for jax_fn in (jax_dyn8, jax_dyn8_resident):
        ref = np.asarray(jax_fn(jp, jnp.asarray(x), tile=128, interpret=True))
        _assert_close(ours, ref)


def test_entry_names_share_one_path(packs):
    _, tp = packs
    x = torch.from_numpy(_inputs(40, seed=4))
    out = dyn8_forward_plain(tp, x)
    for fn in (fused_loco_forward_dyn8, fused_loco_forward_dyn8_resident,
               fused_loco_forward_dyn8_auto):
        assert torch.equal(fn(tp, x), out)


def test_rows_are_independent_bit_for_bit(packs):
    _, tp = packs
    big = torch.from_numpy(_inputs(512, seed=7))
    out_big = fused_loco_forward_dyn8(tp, big)
    for m in (1, 8, 77, 128):
        assert torch.equal(fused_loco_forward_dyn8(tp, big[:m]), out_big[:m]), m


def test_tracks_f32_under_distribution_shift(folded, packs):
    """Per-row scales follow the data, so a 50x input rescale keeps the
    budget of the JAX package's test (mean|err|/mean|ref| < 0.02)."""
    _, tp = packs
    tf = _tree_to_torch(folded)

    def mean_rel(scale):
        x = torch.from_numpy(_inputs(256, seed=11, scale=scale))
        ref = folded_forward(tf, x).numpy()
        np.testing.assert_allclose(ref, np.asarray(jax_folded_forward(folded, x.numpy())),
                                   rtol=1e-4, atol=1e-4 * scale)
        out = fused_loco_forward_dyn8(tp, x).numpy()
        return np.abs(out - ref).mean() / np.abs(ref).mean()

    r1, r50 = mean_rel(1.0), mean_rel(50.0)
    assert r1 < 0.02 and r50 < 0.02, (r1, r50)
    assert r50 < 2.0 * max(r1, 1e-3) and r1 < 2.0 * max(r50, 1e-3), (r1, r50)


def test_rejects_unaligned_hidden_and_other_devices(packs):
    _, tp = packs
    bad = (torch.zeros(34, 96, dtype=torch.bfloat16),) + tp[1:]
    with pytest.raises(ValueError, match='hidden % 128'):
        fused_loco_forward_dyn8(bad, torch.zeros(8, 34))
    with pytest.raises(ValueError, match='no path'):
        fused_loco_forward_dyn8(tp, torch.zeros(8, 34, device='meta'))


def test_cpu_tensors_never_count_a_launch(packs):
    _, tp = packs
    before = dict(ops.launches)
    fused_loco_forward_dyn8_auto(tp, torch.from_numpy(_inputs(16)))
    assert ops.launches == before
