"""Speed of light of the serving MLP's trunk on one CUDA card.

Counterpart of the JAX package's `tools/bench_roofline.py`. Four
measurements, each a call of passes chained through the data and ended by
one checksum fetch (`bench.time_serving`, the bench's methodology), median
of 5 calls after a warm-up call. Each is one JSON row, under the JAX
tool's `which` names so that the rows compare:

  peak_8192cubed_tflops         8192^3 bf16 `torch.matmul` (bf16 out, f32
                                sums): the card's wide-shape rate;
  chain_xla_tflops              8 dependent relu(y @ W_i) bf16 layers, (B,
                                1024) x (1024, 1024), in `torch.matmul` and
                                `torch.relu` ("xla" names the library chain
                                here, as XLA's was the JAX tool's);
  chain_pallas_resident_tflops  the same chain through `ops.relu_chain`, the
                                port of the Pallas kernel of that row (K6:
                                csrc/relu_chain.cu, a bf16 relu layer
                                kernel of its own, one launch per layer);
  serve_inf_per_sec             the port bench's bf16 serving program (K^-1
                                -> bf16 folded MLP -> decode, hidden 1024, 3
                                stages), with its trunk-equivalent TFLOP/s
                                (the 8 H x H products' operations over its
                                time, as the JAX tool counts them).

Each row also holds its checksum and the kernel launches it made; the rows
print as JSON lines and, with an output path, go to that file too.

Usage: python -m monoloco_tpu_torch.tools.bench_roofline [out.jsonl] [--batch 131072]
"""

import argparse
import json

import numpy as np
import torch

from .. import bench
from ..ops import launches, relu_chain

B, H, L = 131072, 1024, 8
PEAK_N = 8192


def chain_flops(batch):
    return 2 * batch * H * H * L


def chain_inputs(batch, device):
    """x (batch, H) ~ N(0, 1) and L weights (H, H) ~ N(0, 0.01^2), bf16,
    from numpy seed 0 (the JAX tool's draws)."""
    rng = np.random.RandomState(0)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)

    x = bf16(rng.randn(batch, H))
    return x, [bf16(rng.randn(H, H) * 0.01) for _ in range(L)]


def relu_chain_library(x, ws):
    """The chain in `torch.matmul` (bf16 out, f32 sums) and `torch.relu`:
    bf16(relu(v)) == relu(bf16(v)), so it computes `relu_chain`'s function."""
    y = x
    for w in ws:
        y = torch.relu(torch.matmul(y, w))
    return y


def _timed(fn, x, length, reps):
    """(median seconds of one call of `length` chained passes, checksum)."""
    median_s, checksum, _ = bench.time_serving(lambda v, _: (fn(v),), x, None, length, reps=reps)
    return median_s / length, checksum


def measure_rows(batch=B, peak_n=PEAK_N, device='cuda', reps=5):
    """The four rows on `device`. A CPU run checks the control flow only: its
    rates are no device metric."""
    rows = []

    def row(which, value, checksum, ran, **more):
        rows.append({'which': which, 'value': value, **more, 'checksum': checksum,
                     'launches': ran})

    def ran_since(before):
        return {k: v - before[k] for k, v in launches.items() if v != before[k]}

    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(peak_n, peak_n).astype(np.float32)).to(device, torch.bfloat16)
    b = torch.from_numpy((rng.randn(peak_n, peak_n) * 0.01).astype(np.float32)).to(
        device, torch.bfloat16)
    dt, checksum = _timed(lambda v: torch.matmul(v, b), a, 8, reps)
    row('peak_8192cubed_tflops', 2 * peak_n ** 3 / dt / 1e12, checksum, {}, n=peak_n)
    del a, b

    x, ws = chain_inputs(batch, device)
    for which, fn in (('chain_xla_tflops', relu_chain_library),
                      ('chain_pallas_resident_tflops', relu_chain)):
        before = dict(launches)
        dt, checksum = _timed(lambda v, f=fn: f(v, ws), x, 4, reps)
        row(which, chain_flops(batch) / dt / 1e12, checksum, ran_since(before), batch=batch,
            ms=dt * 1e3)
    del x, ws

    inf_s, checksum, ran = bench.measure(bench.bench_folded(hidden=H, device=device), 'bf16',
                                         batch, scan_iters=8, device=device)
    row('serve_inf_per_sec', inf_s, checksum, ran, batch=batch,
        trunk_equiv_tflops=chain_flops(batch) * inf_s / batch / 1e12)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('out', nargs='?', help='also write the JSON rows to this file')
    parser.add_argument('--batch', type=int, default=B)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_roofline measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    device = torch.cuda.get_device_name(0)
    rows = measure_rows(args.batch, device='cuda')
    for r in rows:
        r['device'] = device
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            for r in rows:
                f.write(json.dumps(r) + '\n')
    return rows


if __name__ == '__main__':
    main()
