"""K6's kernel, csrc/relu_chain.cu, on a card.

Marked `cuda`: without a CUDA device every test skips (the kernel has no
CPU mode). Like tests/test_torch_kernels_cuda.py this file imports neither
jax nor the JAX package; run it on the GPU machine with
    python -m pytest --noconftest tests/test_torch_relu_chain_cuda.py
Inputs: x ~ N(0, 1), eight weights ~ N(0, 2 / H) from a numpy seed, so the
activations stay O(1) through the chain. Rules:
 - against `relu_chain_plain` (float64 sums), the bf16 rule of
   tests/test_torch_kernels_cuda.py: the tensor cores' f32 sums flip some
   bf16 roundings, which carry into the later layers, so no output differs
   by more than 5e-2 of the largest and the mean difference stays under
   5e-3 of the mean output;
 - against the chain on csrc/wgmma_layer.cu's relu layer with a zero bias
   (the path K6 ran on before): bit for bit, since both run wgmma
   m64nBNk16 with the same BN and the same k order and round
   bf16(relu(acc)) alike;
 - a row never depends on the batch around it: a prefix of the batch gives
   the same bits.
The row counts are the kernel's edges: one row, a row block short of or just
past 128 rows (the second block of the last 2-block cluster has no rows at
m = 1 and 257), and a ragged 131071.
"""

import numpy as np
import pytest
import torch

from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import fused_mlp

pytestmark = pytest.mark.cuda

ROWS = (1, 127, 129, 257, 131071)
HIDDEN = (128, 256, 384, 1024, 2048)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


def _operands(m, hidden, device, layers=8, seed=0):
    rng = np.random.default_rng(seed + hidden)
    x = torch.from_numpy(rng.normal(size=(m, hidden)).astype(np.float32))
    ws = [torch.from_numpy((rng.normal(size=(hidden, hidden)) * (2 / hidden) ** 0.5)
                           .astype(np.float32)) for _ in range(layers)]
    return (x.to(device, torch.bfloat16),
            [w.to(device, torch.bfloat16) for w in ws])


@pytest.mark.parametrize('hidden', HIDDEN)
def test_relu_chain_kernel_matches_plain_and_the_wgmma_layer_path(cuda_device, hidden):
    x_all, ws = _operands(max(ROWS), hidden, cuda_device)
    for m in ROWS:
        x = x_all[:m].contiguous()
        before = ops.launches['relu_chain_bf16']
        out = ops.relu_chain(x, ws)
        torch.cuda.synchronize()
        assert ops.launches['relu_chain_bf16'] == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == (m, hidden)
        ref = ops.relu_chain_plain(x, ws).float()
        diff = (out.float() - ref).abs()
        assert float(diff.max()) <= 5e-2 * float(ref.abs().max()), (m, float(diff.max()))
        assert float(diff.mean()) <= 5e-3 * float(ref.abs().mean()), (m, float(diff.mean()))
        old = fused_mlp._relu_chain_wgmma_layer(x, ws)
        assert torch.equal(out, old), (m, float((out.float() - old.float()).abs().max()))


@pytest.mark.parametrize('hidden', [384, 1024])
def test_relu_chain_rows_are_independent(cuda_device, hidden):
    x, ws = _operands(max(ROWS), hidden, cuda_device, seed=1)
    out = ops.relu_chain(x, ws)
    for m in ROWS[:-1] + (512,):
        assert torch.equal(ops.relu_chain(x[:m].contiguous(), ws), out[:m]), m


def test_relu_chain_takes_a_stack_one_layer_and_no_rows(cuda_device):
    x, ws = _operands(257, 1024, cuda_device, layers=3, seed=2)
    out = ops.relu_chain(x, ws)
    assert torch.equal(ops.relu_chain(x, torch.stack(ws)), out)
    one = ops.relu_chain(x, ws[:1])
    assert torch.equal(one, fused_mlp._relu_chain_wgmma_layer(x, ws[:1]))
    before = ops.launches['relu_chain_bf16']
    empty = ops.relu_chain(x[:0], ws)
    assert empty.shape == (0, 1024) and empty.dtype == torch.bfloat16
    assert ops.launches['relu_chain_bf16'] == before      # nothing launched


def test_relu_chain_refuses_what_the_kernel_does_not_take(cuda_device):
    x, ws = _operands(16, 256, cuda_device, layers=2)
    with pytest.raises(ValueError, match='hidden % 128'):
        ops.relu_chain(torch.zeros((4, 192), dtype=torch.bfloat16, device=cuda_device),
                       [torch.zeros((192, 192), dtype=torch.bfloat16, device=cuda_device)])
    with pytest.raises(ValueError, match='dtype'):
        ops.relu_chain(x.float(), ws)
    with pytest.raises(ValueError, match='shape'):
        ops.relu_chain(x, [ws[0][:128]])
    with pytest.raises(ValueError, match='at least one layer'):
        ops.relu_chain(x, [])
