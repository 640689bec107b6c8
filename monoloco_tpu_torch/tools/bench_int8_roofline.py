"""The int8 ceiling of one CUDA card, and where the served dyn8 kernel sits under it.

Counterpart of the JAX package's `tools/bench_int8_roofline.py`. That tool
has no Pallas kernel: it measures XLA's int8 dot. Here the yardstick is
`torch._int_mm` (s8 x s8 -> s32), the one PyTorch call for an int8
product, as the port's `bench_roofline` uses `torch.matmul` for the bf16
peak. Four legs, each a call of passes chained through the data and ended
by one host fetch of the last pass's carry (the serve leg: `bench.measure`,
the bench's methodology), median of 5 calls after a warm-up call, one JSON
row each under the JAX tool's `which` names:

  peak_int8_8192cubed_tops     8192^3 int8 products, int32 sums, each pass's
                               A xor-ed with the previous pass's c & 1 (the
                               JAX tool's `:78-83`): cuBLAS's wide-shape
                               int8 rate, B column-major (row-major B ran
                               6.5x slower on an H100). A library's rate at
                               one layout, not the card's peak: it is
                               printed beside the published peak
                               (PUBLISHED_INT8_TOPS) and bounds nothing;
  chain_int8_noquant_tops      8 dependent (131072, 1024) @ (1024, 1024)
                               int8 layers with `>> 8` back to int8 between
                               them (`:95-125`): the optimistic shape ceiling;
  chain_int8_dyn_requant_tops  the same chain with per-row dynamic
                               requantization between layers in torch ops
                               (row |max|, 127 / max, round half to even,
                               int8), what the dyn8 kernel does; XLA's and
                               torch's chains pay each requantization as a
                               memory round trip, so the fused kernel may
                               land above it (pct_of_dyn_requant_ceiling >
                               100 means "beats the library chain", not
                               "beats physics");
  serve_dyn8                   the port bench's program under int8 (K^-1 ->
                               the served dyn8 kernel -> decode, hidden
                               1024, 3 stages) in inferences/s, and its
                               trunk-equivalent TOPS (the 8 H x H products'
                               operations over its time).

The JAX tool sweeps the Pallas kernel's tile (256, 512, 1024) and its
resident flavour; the port's dyn8 kernel has one tiling (128-row tiles,
persistent), so there is one serve row. The summary row: the TOPS of each
leg beside the published int8 peak, dyn8's share of chain-int8 and of
peak-int8, and the JAX tool's pct_of_dyn_requant_ceiling,
pct_of_noquant_ceiling, requant_tax_pct and l0_head_flop_share_pct.

Usage: python -m monoloco_tpu_torch.tools.bench_int8_roofline [--out rows.jsonl]
(card only: it raises without one).
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import bench

B, H, L = 131072, 1024, 8
PEAK_N = 8192
HEAD_DIMS = 34 + 10             # l0's inputs and the widest heads (the JAX tool's count)
PUBLISHED_INT8_TOPS = 1979.0    # one H100 SXM, dense (NVIDIA's data sheet)


def chain_ops(batch=B, hidden=H, layers=L):
    return 2 * batch * hidden * hidden * layers


def int8_inputs(shape, rng, device):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)).to(device)


def column_major(w):
    """The same (k, n) matrix stored column by column: cuBLAS's int8 tensor
    core path takes B so (`torch._int_mm(a, w)` with a row-major w ran
    several times slower on an H100 80GB HBM3, PERF.md section 6)."""
    return w.t().contiguous().t()


def chain_inputs(batch, hidden, layers, device):
    """x (batch, hidden) and `layers` weights (hidden, hidden), int8 uniform in
    [-127, 127], from numpy seed 0 in the JAX tool's order; the weights
    column-major."""
    rng = np.random.RandomState(0)
    x = int8_inputs((batch, hidden), rng, device)
    return x, [column_major(int8_inputs((hidden, hidden), rng, device)) for _ in range(layers)]


def requant_rows(acc):
    """int32 (m, n) -> int8: per row, round(acc * 127 / max(|row max|, 1e-6)),
    half to even (the JAX tool's `jnp.round`). The scale is a tensor divided
    by a tensor: `scalar / tensor` is a reciprocal-multiply in PyTorch."""
    f = acc.float()
    m = torch.clamp(f.abs().amax(dim=1, keepdim=True), min=1e-6)
    return torch.round(f * (torch.full_like(m, 127.0) / m)).to(torch.int8)


def chain_pass(x, ws, c, requant):
    """One pass of the chain: x xor-ed with c & 1, then each layer's int32
    product back to int8 (`>> 8`, or the per-row requantization)."""
    y = x ^ (c & 1).to(torch.int8)
    for w in ws:
        acc = torch._int_mm(y, w)
        y = requant_rows(acc) if requant else (acc >> 8).to(torch.int8)
    return y


def _chained(step, x, length):
    """`length` passes of `step(x, c) -> (out, next c)`, c starting at 0 and
    carried through the data; returns the host fetch of the last c."""
    c = torch.zeros((), dtype=torch.int32, device=x.device)
    for _ in range(length):
        _, c = step(x, c)
    return int(c)


def _timed(step, x, length, reps):
    """Median seconds of one pass over `reps` calls of `length` chained
    passes, after a warm-up call, and the last call's checksum."""
    checksum = _chained(step, x, length)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        checksum = _chained(step, x, length)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) / length, checksum


def measure_rows(batch=B, hidden=H, layers=L, peak_n=PEAK_N, device='cuda', reps=5):
    """The four legs' rows and the summary on `device`. A CPU run checks the
    control flow only: its rates are no device metric."""
    rows = []
    rng = np.random.RandomState(0)
    a = int8_inputs((peak_n, peak_n), rng, device)
    b = column_major(int8_inputs((peak_n, peak_n), rng, device))

    def peak_step(v, c):
        out = torch._int_mm(v ^ (c & 1).to(torch.int8), b)
        return out, out[0, 0]

    dt, checksum = _timed(peak_step, a, 8, reps)
    peak = 2 * peak_n ** 3 / dt / 1e12
    rows.append({'which': 'peak_int8_8192cubed_tops', 'value': peak, 'n': peak_n,
                 'ms': dt * 1e3, 'checksum': checksum})
    del a, b

    x, ws = chain_inputs(batch, hidden, layers, device)
    ops = chain_ops(batch, hidden, layers)
    rates = {}
    for which, requant in (('chain_int8_noquant_tops', False),
                           ('chain_int8_dyn_requant_tops', True)):
        def step(v, c, requant=requant):
            y = chain_pass(v, ws, c, requant)
            return y, y[0, 0].to(torch.int32)

        dt, checksum = _timed(step, x, 4, reps)
        rates[which] = ops / dt / 1e12
        rows.append({'which': which, 'value': rates[which], 'batch': batch, 'ms': dt * 1e3,
                     'checksum': checksum})
    del x, ws

    folded = bench.bench_folded(hidden=hidden, device=device)
    inf_s, checksum, ran = bench.measure(folded, 'int8', batch, scan_iters=8, device=device)
    if torch.device(device).type == 'cuda' and not ran.get('dyn8_mlp'):
        raise RuntimeError(f"serve_dyn8 did not launch the dyn8 kernel: {ran}")
    serve_tops = ops * inf_s / batch / 1e12
    rows.append({'which': 'serve_dyn8', 'inf_per_sec': inf_s, 'trunk_equiv_tops': serve_tops,
                 'batch': batch, 'checksum': checksum, 'launches': ran})
    cn, cq = rates['chain_int8_noquant_tops'], rates['chain_int8_dyn_requant_tops']
    rows.append({
        'which': 'summary',
        'peak_int8_tops': peak, 'published_int8_tops': PUBLISHED_INT8_TOPS,
        'chain_int8_tops': cn, 'chain_dyn8_tops': cq,
        'serve_trunk_equiv_tops': serve_tops,
        'serve_minf_s': round(inf_s / 1e6, 2),
        'pct_of_dyn_requant_ceiling': round(100 * serve_tops / cq, 1),
        'pct_of_noquant_ceiling': round(100 * serve_tops / cn, 1),
        'pct_of_peak_int8': round(100 * serve_tops / peak, 1),
        'requant_tax_pct': round(100 * (1 - cq / cn), 1),
        'l0_head_flop_share_pct': round(100 * HEAD_DIMS / (layers * hidden), 2),
    })
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', help='also write the JSON rows to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_int8_roofline measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    device = torch.cuda.get_device_name(0)
    rows = measure_rows(device='cuda')
    for r in rows:
        r['device'] = device
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            for r in rows:
                f.write(json.dumps(r) + '\n')
    s = rows[-1]
    print(f"serve dyn8: {s['serve_minf_s']:.2f} M inf/s = {s['serve_trunk_equiv_tops']:.1f} "
          f"TOPS trunk-equivalent; {s['pct_of_dyn_requant_ceiling']:.1f}% of the dyn-requant "
          f"chain ({s['chain_dyn8_tops']:.1f}), {s['pct_of_noquant_ceiling']:.1f}% of the "
          f"no-requant chain ({s['chain_int8_tops']:.1f}), {s['pct_of_peak_int8']:.1f}% of "
          f"cuBLAS _int_mm at 8192^3 ({s['peak_int8_tops']:.1f} TOPS; published peak "
          f"{s['published_int8_tops']:.0f}) on {device}", flush=True)
    return rows


if __name__ == '__main__':
    main()
