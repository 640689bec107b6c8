"""Where the engine's int8 routing floor should lie on this card.

Counterpart of the JAX package's `tools/bench_int8_crossover.py`. Under
MONOLOCO_TPU_PRECISION=int8 the engine runs a dispatch of at least
`network.engine._INT8_MIN_ROWS` padded rows through the dyn8 kernel and a
smaller one through the f32 `FoldedLoco` (torch.matmul). For each row count
this tool times the FULL serving program (K^-1 keypoint normalization ->
folded MLP -> physical decode, the bench's shape: hidden 1024, 3 stages,
weights from `init_loco_params(0, 34, 9, 1024, 3)`) with the MLP on each
path:
  - dyn8: `fused_loco_forward_dyn8_auto` on the int8 pack (the kernel);
  - f32: `FoldedLoco`, what the engine serves below the floor;
  - bf16: K1-bf16 (`fused_loco_forward` on a bf16 pack), a third column.
The JAX tool compares dyn8 with bf16, which is what the JAX engine serves
below its floor on a TPU.

Methodology, as the bench's: every path in one process, interleaved per row
count (one warm-up call each, then the timed calls in turns), each call
SCAN_ITERS passes chained through the data and ended by one checksum fetch
(`bench.chained_call`), the median of --reps calls. Each row count also
records the decoded distance's relative deviation, dyn8 against f32, on the
same inputs: per row as the JAX tool has it (mean, p99, max of |d8 - d32| /
max(|d32|, 1e-6), which the random weights' distances near 0 inflate) and
`of_means`, mean |d8 - d32| over mean |d32| (`mean_abs_d_f32`).

The crossover is the JAX rule: the smallest measured row count at which
dyn8 beats f32 and keeps beating it at every larger measured count (None if
it never does). Prints one JSON line per row count and a summary line; it
writes no file.

Usage: python -m monoloco_tpu_torch.tools.bench_int8_crossover
           [--rows 16,32,64,128,256,512,1024,2048,8192,131072] [--reps 5]
It refuses to run without a CUDA card.
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import bench
from ..models import FoldedLoco
from ..network.decode import extract_outputs
from ..network.preprocess import preprocess_monoloco
from ..ops import (fused_loco_forward, fused_loco_forward_dyn8_auto, launches,
                   pack_folded_weights, pack_folded_weights_w8)

SCAN_ITERS = 16
ROWS = (16, 32, 64, 128, 256, 512, 1024, 2048, 8192, 131072)
PATHS = ('dyn8', 'f32', 'bf16')


def build_paths(folded):
    """{path: mlp(inputs (m, 34) f32) -> raw (m, 9) f32}, packed once."""
    w8 = pack_folded_weights_w8(folded)
    bf16 = pack_folded_weights(folded, torch.bfloat16)
    return {'dyn8': lambda x: fused_loco_forward_dyn8_auto(w8, x, tile=512),
            'f32': FoldedLoco(folded),
            'bf16': lambda x: fused_loco_forward(None, x, packed=bf16)}


def measure_rows(paths, n, reps=5, scan_iters=SCAN_ITERS, device='cuda'):
    """One row count: every path timed in turns and the dyn8-vs-f32
    decoded-distance deviation. Returns the record."""
    rng = np.random.RandomState(n)
    keypoints = torch.from_numpy((rng.rand(n, 3, 17) * 300).astype(np.float32)).to(device)
    kk = torch.tensor(bench.KITTI_KK, dtype=torch.float32, device=device)

    def serve(mlp):
        return lambda kps, k: bench.serve_once(lambda _w, x: mlp(x), None, kps, k)

    times = {name: [] for name in paths}
    checksums, ran = {}, {}
    with torch.inference_mode():
        for name, mlp in paths.items():           # warm-up, every path first
            before = dict(launches)
            checksums[name] = bench.chained_call(serve(mlp), keypoints, kk, scan_iters)
            ran[name] = {k: v - before[k] for k, v in launches.items() if v != before[k]}
        for _ in range(reps):
            for name, mlp in paths.items():
                t0 = time.perf_counter()
                checksums[name] = bench.chained_call(serve(mlp), keypoints, kk, scan_iters)
                times[name].append(time.perf_counter() - t0)
        inputs = preprocess_monoloco(keypoints, kk)
        d32 = extract_outputs(paths['f32'](inputs))['xyzd'][:, 3].double().cpu().numpy()
        d8 = extract_outputs(paths['dyn8'](inputs))['xyzd'][:, 3].double().cpu().numpy()
    rel = np.abs(d8 - d32) / np.maximum(np.abs(d32), 1e-6)
    med = {name: statistics.median(v) for name, v in times.items()}
    rec = {'rows': n}
    for name in paths:
        rec[f'{name}_inf_per_s'] = round(n * scan_iters / med[name], 1)
    rec['dyn8_over_f32'] = round(med['f32'] / med['dyn8'], 3)
    if 'bf16' in paths:
        rec['bf16_over_f32'] = round(med['f32'] / med['bf16'], 3)
    rec['per_call_ms'] = {name: round(1e3 * med[name] / scan_iters, 4) for name in paths}
    rec['rel_dd_vs_f32'] = {'mean': float(rel.mean()), 'p99': float(np.percentile(rel, 99)),
                            'max': float(rel.max()),
                            'of_means': float(np.abs(d8 - d32).mean() / np.abs(d32).mean()),
                            'mean_abs_d_f32': float(np.abs(d32).mean())}
    rec['checksum'] = checksums
    rec['launches'] = ran
    return rec


def crossover(records):
    """The smallest measured row count at which dyn8 wins and keeps winning
    at every larger measured count, or None."""
    records = sorted(records, key=lambda r: r['rows'])
    for i, rec in enumerate(records):
        if all(r['dyn8_over_f32'] > 1.0 for r in records[i:]):
            return rec['rows']
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--rows', default=','.join(str(r) for r in ROWS))
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_int8_crossover measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    device = torch.cuda.get_device_name(0)
    paths = build_paths(bench.bench_folded(device='cuda'))
    rows = [int(r) for r in args.rows.split(',')]
    records = []
    for n in rows:
        rec = measure_rows(paths, n, args.reps)
        rec['device'] = device
        print(json.dumps(rec), flush=True)
        records.append(rec)
    summary = {'summary': 'int8_crossover', 'crossover_rows': crossover(records),
               'rows_measured': rows, 'device': device}
    print(json.dumps(summary), flush=True)
    return records + [summary]


if __name__ == '__main__':
    main()
