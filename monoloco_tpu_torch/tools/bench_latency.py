"""Serving latency: the round trip of one dispatch of the serving program.

Counterpart of the JAX package's `tools/bench_latency.py`. Where the bench
measures throughput at a saturating batch, this measures the latency of a
single dispatch at request-sized batches. For each batch in --batches and
each serving precision in --precisions it times, after --warmup calls,
--reps round trips of

    host -> K^-1 normalize -> folded MLP (hidden 1024, 3 stages, random
    weights from `init_loco_params(0, 34, 9, 1024, 3)`) -> physical decode
    -> checksum fetch (the one synchronisation)

and reports p50/p90/p99/min/max. First it measures the round-trip floor:
the same discipline for a trivial scalar add on the card, so that compute
latency is separable from launch and fetch (`p50_minus_floor_ms`).

The JAX tool has one leg, the TPU's bf16 default. The port's legs are its
serving precisions: `default` (the f32 `FoldedLoco`, torch.matmul), `bf16`
(the K1-bf16 kernel on a pack made once) and `int8` (the dyn8 kernel at
every batch, as if the routing floor were 0).

Prints one JSON line for the floor and one per (precision, batch).

Usage: python -m monoloco_tpu_torch.tools.bench_latency
           [--batches 1,16,256,4096] [--reps 200] [--warmup 20]
           [--precisions default,bf16,int8]
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
from ..ops import (fused_loco_forward, fused_loco_forward_dyn8_auto, launches,
                   pack_folded_weights, pack_folded_weights_w8)

PRECISIONS = ('default', 'bf16', 'int8')


def percentiles(xs):
    xs = sorted(xs)

    def pct(p):
        return xs[min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))]

    return {'p50': statistics.median(xs), 'p90': pct(90), 'p99': pct(99),
            'min': xs[0], 'max': xs[-1]}


def build_mlps(folded, precisions=PRECISIONS):
    """{precision: mlp(inputs (m, 34) f32) -> raw (m, 9) f32}, with the
    weights packed once here."""
    mlps = {}
    for name in precisions:
        if name == 'default':
            mlps[name] = FoldedLoco(folded)
        elif name == 'bf16':
            packed = pack_folded_weights(folded, torch.bfloat16)
            mlps[name] = lambda x, p=packed: fused_loco_forward(None, x, packed=p)
        elif name == 'int8':
            packed = pack_folded_weights_w8(folded)
            mlps[name] = lambda x, p=packed: fused_loco_forward_dyn8_auto(p, x)
        else:
            raise ValueError(f"unknown precision {name!r}: choose from {PRECISIONS}")
    return mlps


def serve_checksum(mlp, keypoints, kk):
    """One serving dispatch (`bench.serve_once`), ended by the fetch of its
    4-byte checksum."""
    return float(sum(o.sum() for o in bench.serve_once(lambda _w, x: mlp(x), None,
                                                        keypoints, kk)))


def _round_trips(fn, reps, warmup):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return percentiles(times)


def _ms(stats):
    return {k: round(v * 1e3, 3) for k, v in stats.items()}


def measure(folded, batches, precisions=PRECISIONS, reps=200, warmup=20, device='cuda'):
    """The floor record, then one record per (precision, batch); each is
    printed as a JSON line and returned."""
    records = []
    where = torch.cuda.get_device_name(0) if torch.device(device).type == 'cuda' else 'cpu'

    def emit(rec):
        rec['device'] = where
        print(json.dumps(rec), flush=True)
        records.append(rec)

    mlps = build_mlps(folded, precisions)
    kk = torch.tensor(bench.KITTI_KK, dtype=torch.float32, device=device)
    with torch.inference_mode():
        x0 = torch.zeros((), device=device)
        fstats = _round_trips(lambda: float(x0 + 1.0), reps, 1)
        emit({'metric': 'dispatch_floor_ms', **_ms(fstats)})
        rng = np.random.RandomState(0)
        for batch in batches:
            keypoints = torch.from_numpy(
                (rng.rand(batch, 3, 17) * 300).astype(np.float32)).to(device)
            for name, mlp in mlps.items():
                before = dict(launches)
                checksum = serve_checksum(mlp, keypoints, kk)
                st = _round_trips(lambda m=mlp: serve_checksum(m, keypoints, kk), reps, warmup)
                ran = {k: v - before[k] for k, v in launches.items() if v != before[k]}
                emit({'metric': 'serving_latency_ms', 'precision': name, 'batch': batch,
                      **_ms(st),
                      'p50_minus_floor_ms': round((st['p50'] - fstats['p50']) * 1e3, 3),
                      'inferences_per_sec_at_p50': round(batch / st['p50'], 1),
                      'checksum': checksum, 'launches': ran})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batches', default='1,16,256,4096')
    ap.add_argument('--reps', type=int, default=200)
    ap.add_argument('--warmup', type=int, default=20)
    ap.add_argument('--precisions', default=','.join(PRECISIONS),
                    help=f'comma list of {PRECISIONS}')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_latency measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    folded = bench.bench_folded(device='cuda')
    return measure(folded, [int(b) for b in args.batches.split(',')],
                   tuple(args.precisions.split(',')), args.reps, args.warmup)


if __name__ == '__main__':
    main()
