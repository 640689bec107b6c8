"""K6, the roofline probe's resident relu chain, and the ported roofline tool.

The Pallas kernel of `tools/bench_roofline.py` (`bench_chain_resident`) is a
closure inside a timing function, so no JAX entry returns its output: the
port's `relu_chain_plain` is held against the kernel body's own jnp
expressions (`jnp.dot(..., preferred_element_type=f32)`, `jnp.maximum`, the
bf16 cast) on the CPU, at 256 x 256 x 8 with weights from numpy seeds.
Tolerance, the bf16 rule: both sum each product in f32 or better and round
it to bf16, and the two sum orders differ in the last bits, so a bf16
rounding flips now and then (one bf16 ulp, 2^-8 relative) and carries into
the next layers: at most 1% of the outputs differ at all, none by more than
5e-2 of the largest output, and the mean difference stays within 1e-3 of
the mean output.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import relu_chain, relu_chain_plain
from monoloco_tpu_torch.tools import bench_roofline

M, H, L = 256, 256, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chain_inputs(scale, seed=0, m=M, hidden=H, layers=L):
    """x ~ N(0, 1) and `layers` weights ~ N(0, scale^2) as float32 numpy;
    scale 'he' keeps the activations O(1) through the chain (sqrt(2 /
    hidden)), 'tool' is the roofline tool's 0.01."""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2.0 / hidden) if scale == 'he' else 0.01
    x = rng.normal(size=(m, hidden)).astype(np.float32)
    return x, [(rng.normal(size=(hidden, hidden)) * std).astype(np.float32)
               for _ in range(layers)]


def _pallas_body(x, ws):
    """The Pallas kernel's body (tools/bench_roofline.py:100-106) on the CPU."""
    y = jnp.asarray(x, jnp.bfloat16)
    for w in ws:
        y = jnp.dot(y, jnp.asarray(w, jnp.bfloat16), preferred_element_type=jnp.float32)
        y = jnp.maximum(y, 0).astype(jnp.bfloat16)
    return np.asarray(y.astype(jnp.float32))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_bf16_rule(ours, ref):
    diff = np.abs(ours - ref)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert diff.max() <= 5e-2 * np.abs(ref).max(), diff.max()
    assert diff.mean() <= 1e-3 * np.abs(ref).mean(), diff.mean()


@pytest.mark.parametrize('scale', ['he', 'tool'])
def test_relu_chain_plain_matches_the_pallas_body(scale):
    x, ws = _chain_inputs(scale)
    ours = relu_chain_plain(_bf16(x), [_bf16(w) for w in ws])
    assert ours.dtype == torch.bfloat16 and ours.shape == (M, H)
    ref = _pallas_body(x, ws)
    assert np.abs(ref).max() > 0
    _assert_bf16_rule(ours.float().numpy(), ref)


@pytest.mark.parametrize('layers', [1, 8])
@pytest.mark.parametrize('hidden', [128, 256, 384])
@pytest.mark.parametrize('m', [1, 127, 129, 257])
def test_relu_chain_plain_matches_the_pallas_body_at_the_kernels_edges(m, hidden, layers):
    """The shapes the card holds csrc/relu_chain.cu at for its edges: one
    row, a row block short of or just past 128 rows (a cluster's second
    block without rows at m = 1 and 257), 256-column tiles at H = 256 and
    128-column tiles at H = 128 and 384."""
    x, ws = _chain_inputs('he', seed=m + hidden + layers, m=m, hidden=hidden, layers=layers)
    ours = relu_chain_plain(_bf16(x), [_bf16(w) for w in ws])
    assert ours.dtype == torch.bfloat16 and ours.shape == (m, hidden)
    ref = _pallas_body(x, ws)
    assert np.abs(ref).max() > 0
    _assert_bf16_rule(ours.float().numpy(), ref)


def test_relu_chain_on_the_cpu_is_its_plain_version():
    """A CPU tensor runs the plain chain and counts no launch; a stacked (L,
    H, H) weight tensor works like a list; another device is refused."""
    x, ws = _chain_inputs('he', seed=1)
    xt, wt = _bf16(x), [_bf16(w) for w in ws]
    before = dict(ops.launches)
    out = relu_chain(xt, wt)
    assert ops.launches == before
    assert torch.equal(out, relu_chain_plain(xt, wt))
    assert torch.equal(relu_chain(xt, torch.stack(wt)), out)
    with pytest.raises(ValueError, match='no path'):
        relu_chain(torch.zeros((8, 128), dtype=torch.bfloat16, device='meta'), wt)


def test_library_chain_computes_the_same_function():
    """The tool's `torch.matmul` chain (its chain_xla row) against the plain
    chain: the same function under the bf16 rule."""
    x, ws = _chain_inputs('he', seed=2)
    xt, wt = _bf16(x), [_bf16(w) for w in ws]
    _assert_bf16_rule(bench_roofline.relu_chain_library(xt, wt).float().numpy(),
                      relu_chain_plain(xt, wt).float().numpy())


def test_roofline_rows_at_batch_16_on_the_cpu():
    """The four rows of the JAX tool at a toy size (batch 16, a 64^3 peak):
    the control flow and the checksums only, a CPU rate being no device
    metric."""
    rows = bench_roofline.measure_rows(batch=16, peak_n=64, device='cpu', reps=1)
    assert [r['which'] for r in rows] == ['peak_8192cubed_tflops', 'chain_xla_tflops',
                                          'chain_pallas_resident_tflops', 'serve_inf_per_sec']
    for r in rows:
        assert np.isfinite(r['value']) and r['value'] > 0, r
        assert np.isfinite(r['checksum']) and r['launches'] == {}, r
    assert rows[3]['batch'] == 16 and rows[3]['trunk_equiv_tflops'] > 0


def test_roofline_rows_keep_the_jax_tools_names():
    with open(os.path.join(REPO, 'tools', 'bench_roofline.py')) as f:
        jax_names = re.findall(r"'which': '(\w+)'", f.read())
    with open(bench_roofline.__file__) as f:
        source = f.read()
    assert len(jax_names) == 4
    for name in jax_names:
        assert f"'{name}'" in source, name
    assert (bench_roofline.B, bench_roofline.H, bench_roofline.L) == (131072, 1024, 8)
    # The bound of the card's run: 2.2 TFLOP, 2.22 ms at the bf16 peak.
    assert bench_roofline.chain_flops(131072) == 2 * 131072 * 1024 ** 2 * 8


def test_roofline_tool_refuses_without_cuda(monkeypatch):
    """A measurement never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        bench_roofline.main(['--batch', '16'])
