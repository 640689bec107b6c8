"""The dyn8 CUDA kernel against its plain PyTorch version, on a card.

Marked `cuda`: without a CUDA device every test skips (the kernel has no CPU
mode). This file imports neither jax nor the JAX package, so it runs on the
GPU machine, where jax is not installed; tests/conftest.py imports jax, so
run it there with
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Weights come from a numpy seed with perturbed BN statistics. Tolerance: the
kernel and the plain version quantize identically and differ only in the f32
sum order of the bf16 layers. A last-ulp difference there can flip one
rounding tie of a later quantization, which moves all outputs of that row
by up to ~1e-2 (measured on the H100: about 2-3% of the rows at hidden 1024
with normal inputs). So at most 10% of the rows may hold an output that
differs by more than 1e-5 (1 + |ref|), no output by more than 5e-2, and the
mean difference stays under 1e-3 of the mean output; a wrong kernel misses
all three. A row never
depends on the rows around it (bit for bit).
"""

import numpy as np
import pytest
import torch

from monoloco_tpu_torch import ops
from monoloco_tpu_torch.models import fold_eval_params, init_loco_params
from monoloco_tpu_torch.ops import (dyn8_forward_plain, fused_loco_forward_dyn8_auto,
                                    pack_folded_weights_w8)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the dyn8 kernel has no CPU mode')
    return torch.device('cuda')


def _packed(in_dim, out_dim, hidden, device, seed=0):
    params, bn = init_loco_params(seed, in_dim, out_dim, hidden, 3)
    rng = np.random.default_rng(seed)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = torch.from_numpy(rng.normal(0, 0.1, tuple(s['mean'].shape)).astype(np.float32))
        s['var'] = torch.from_numpy(rng.uniform(0.5, 2.0, tuple(s['var'].shape)).astype(np.float32))
    folded = fold_eval_params(params, bn)
    return tuple(t.to(device) for t in pack_folded_weights_w8(folded))


def _inputs(m, in_dim, device, seed=1):
    x = np.random.default_rng(seed).normal(size=(m, in_dim)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize('in_dim,out_dim,hidden', [(34, 9, 128), (68, 10, 256), (34, 9, 1024)])
def test_kernel_matches_plain(cuda_device, in_dim, out_dim, hidden):
    packed = _packed(in_dim, out_dim, hidden, cuda_device)
    for m in (1, 77, 512):
        x = _inputs(m, in_dim, cuda_device, seed=m)
        before = ops.launches['dyn8_mlp']
        out = fused_loco_forward_dyn8_auto(packed, x)
        torch.cuda.synchronize()
        assert ops.launches['dyn8_mlp'] == before + 1
        assert out.shape == (m, out_dim)
        ref = dyn8_forward_plain(packed, x)
        diff = (out - ref).abs()
        rows_off = float((diff > 1e-5 * (1 + ref.abs())).any(dim=1).float().mean())
        assert rows_off <= 0.1, (m, rows_off)
        assert float(diff.max()) <= 5e-2, (m, float(diff.max()))
        assert float(diff.mean()) <= 1e-3 * float(ref.abs().mean()), (m, float(diff.mean()))


def test_kernel_rows_are_independent(cuda_device):
    packed = _packed(34, 9, 128, cuda_device)
    big = _inputs(512, 34, cuda_device, seed=9)
    out_big = fused_loco_forward_dyn8_auto(packed, big)
    for m in (1, 8, 77):
        assert torch.equal(fused_loco_forward_dyn8_auto(packed, big[:m].contiguous()),
                           out_big[:m])


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
