"""Benchmark: pedestrian inference throughput on one CUDA card.

Counterpart of the root `bench.py`. Measures the full serving compute path —
K^-1 keypoint normalization -> BN-folded residual MLP (MonoLoco++, hidden
1024, 3 stages, random weights from numpy seed 0) -> physical decode
(spherical->cartesian, Laplace spread, yaw) — steady-state, device-resident,
at BATCH rows.

Methodology, as in the JAX bench:
 - `scan_iters` iterations are chained through a device scalar (each one's
   keypoints move by the previous one's first distance x 1e-9), so no
   iteration can be batched, overlapped or dropped;
 - every decoded output is summed into a checksum, and the one host fetch of
   that checksum is the only synchronisation: fetching the bytes cannot lie
   about completion;
 - the reported value is the median of 5 timed calls after one warm-up call
   (which also builds the CUDA kernels at first use).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the labels
("precision", and per-path values when both serving configurations are
measured), each path's checksum and kernel launches, and the card's name.
vs_baseline is against the north-star target of 50,000 inferences/sec/chip.

MONOLOCO_TPU_PRECISION pins the measured path, with the JAX bench's
spellings: 'bf16' (and 'default', 'bfloat16': bf16 weights and activations,
`torch.matmul`), 'f32' (and 'float32', 'fp32', 'highest': f32 weights,
`torch.matmul` with TF32 off; 'tensorfloat32' allows TF32 in the MLP), 'int8'
(the dyn8 CUDA kernel, what the engine serves under int8), 'int8-a8' (the
static-calibrated a8w8 CUDA kernel, an ablation) and 'int8-xla' (static int8
in plain torch, ops/quant.py). An unknown value exits. Unset, the bench
measures both serving configurations, bf16 and dyn8, and headlines the
faster; a failure of either fails the run.

    python -m monoloco_tpu_torch.bench [--batch N] [--scan-iters N]
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .models import fold_eval_params, folded_forward, init_loco_params
from .network.decode import extract_outputs
from .network.preprocess import preprocess_monoloco
from .ops import (fused_loco_forward_dyn8_auto, fused_loco_forward_int8, launches,
                  pack_folded_weights_int8, pack_folded_weights_w8)
from .ops.quant import quantize_folded, quantized_forward, synthetic_calibration_inputs
from .utils import precision as _precision  # noqa: F401  (switches TF32 off)

BATCH = 131072
SCAN_ITERS = 16
TARGET = 50_000.0
KITTI_KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]

_KNOWN_PRECISIONS = {'bf16', 'f32', 'int8', 'int8-a8', 'int8-xla',
                     'float32', 'fp32', 'highest', 'bfloat16',
                     'tensorfloat32', 'default'}
# Spellings that pin full-precision matmuls keep f32 weight storage (the JAX
# bench's rule); every other non-int8 spelling stores bf16.
_FULL_STORAGE = ('f32', 'fp32', 'float32', 'highest', 'tensorfloat32')


def check_precision(precision):
    """Exit on a MONOLOCO_TPU_PRECISION the bench does not measure: a bogus
    value must not measure the bf16 path under its own label."""
    if precision is not None and precision not in _KNOWN_PRECISIONS:
        sys.exit(f"MONOLOCO_TPU_PRECISION={precision!r} is not a bench "
                 f"configuration; known: {sorted(_KNOWN_PRECISIONS)}")


def tree_map(fn, tree):
    """fn applied to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@contextlib.contextmanager
def _matmul_tf32(allow):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def build_mlp(folded, precision):
    """(weights, mlp) for one leg, with weights packed or cast once:
    mlp(weights, inputs (m, 34) f32) -> raw (m, 9) f32 outputs."""
    if precision == 'int8':
        return (pack_folded_weights_w8(folded),
                lambda w, x: fused_loco_forward_dyn8_auto(w, x, tile=512))
    if precision in ('int8-a8', 'int8-xla'):
        calib = synthetic_calibration_inputs(34, n=4096, device=folded['l0']['w'].device)
        if precision == 'int8-a8':
            return (pack_folded_weights_int8(folded, calib),
                    lambda w, x: fused_loco_forward_int8(w, x, tile=512))
        return quantize_folded(folded, calib), quantized_forward
    dtype = torch.float32 if precision in _FULL_STORAGE else torch.bfloat16
    tf32 = precision == 'tensorfloat32'

    def mlp(w, x):
        with _matmul_tf32(tf32):
            return folded_forward(w, x.to(dtype)).float()

    return tree_map(lambda t: t.to(dtype), folded), mlp


def serve_once(mlp, weights, keypoints, kk):
    """One serving pass: K^-1 normalize -> MLP -> decode; the decoded
    outputs the checksum consumes."""
    out = extract_outputs(mlp(weights, preprocess_monoloco(keypoints, kk)))
    return out['xyzd'], out['bi'], out['yaw'][0], out['h'], out['w'], out['l']


def bench_keypoints(batch, device):
    """The bench's keypoints (numpy seed 0, uniform over 300 px) and K."""
    rng = np.random.RandomState(0)
    keypoints = torch.from_numpy((rng.rand(batch, 3, 17) * 300).astype(np.float32))
    return keypoints.to(device), torch.tensor(KITTI_KK, dtype=torch.float32, device=device)


def chained_call(serve, keypoints, kk, scan_iters):
    """One timed call: `serve(keypoints, kk)` -> outputs, chained
    `scan_iters` times through the data, ended by the one host fetch of the
    checksum, which it returns. Call it under torch.inference_mode."""
    carry = torch.zeros((), device=keypoints.device)
    total = torch.zeros((), device=keypoints.device)
    for _ in range(scan_iters):
        outs = serve(keypoints + carry * 1e-9, kk)
        total = total + sum(o.sum() for o in outs)
        carry = outs[0][0, 3]
    return float(carry + total)


def time_serving(serve, keypoints, kk, scan_iters, reps=5):
    """Time `serve(keypoints, kk)` -> outputs, chained `scan_iters` times per
    call. Returns (median seconds per call, checksum of the last call,
    seconds of the warm-up call)."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        checksum = chained_call(serve, keypoints, kk, scan_iters)
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            checksum = chained_call(serve, keypoints, kk, scan_iters)
            times.append(time.perf_counter() - t0)
    return statistics.median(times), checksum, warm_s


def measure(folded, precision, batch=BATCH, scan_iters=SCAN_ITERS, device='cuda'):
    """Steady-state serving throughput (inferences/s) of one leg, its
    checksum, and the kernel launches it made. `folded` lies on `device`."""
    weights, mlp = build_mlp(folded, precision)
    keypoints, kk = bench_keypoints(batch, device)
    before = dict(launches)
    median_s, checksum, _ = time_serving(
        lambda kps, k: serve_once(mlp, weights, kps, k), keypoints, kk, scan_iters)
    if checksum != checksum:
        raise RuntimeError(f"nan checksum ({precision})")
    ran = {k: v - before[k] for k, v in launches.items() if v != before[k]}
    return batch * scan_iters / median_s, checksum, ran


def bench_folded(hidden=1024, device='cuda'):
    """The bench's folded weights: MonoLoco++ 34 -> 9, 3 stages, seed 0."""
    params, bn_state = init_loco_params(0, 34, 9, hidden, 3)
    return tree_map(lambda t: t.to(device), fold_eval_params(params, bn_state))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--batch', type=int, default=BATCH)
    parser.add_argument('--scan-iters', type=int, default=SCAN_ITERS)
    args = parser.parse_args(argv)
    precision = os.environ.get('MONOLOCO_TPU_PRECISION')
    check_precision(precision)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    folded = bench_folded(device='cuda')

    def leg(name):
        return measure(folded, name, args.batch, args.scan_iters)

    if precision is not None:
        throughput, checksum, ran = leg(precision)
        record = {"precision": precision, "checksum": checksum, "launches": ran}
    else:
        bf16, cs_bf16, ran_bf16 = leg('bf16')
        dyn8, cs_dyn8, ran_dyn8 = leg('int8')
        if dyn8 > bf16:
            throughput = dyn8
            record = {"precision": "int8-dyn (fused CUDA kernel, opt-in serving path)"}
        else:
            throughput = bf16
            record = {"precision": "bf16"}
        record.update(bf16_inferences_per_sec=round(bf16, 1),
                      int8_dyn_inferences_per_sec=round(dyn8, 1),
                      checksum={"bf16": cs_bf16, "int8": cs_dyn8},
                      launches={"bf16": ran_bf16, "int8": ran_dyn8})
    line = {
        "metric": "pedestrian_inferences_per_sec",
        "value": round(throughput, 1),
        "unit": "inferences/sec/chip",
        "vs_baseline": round(throughput / TARGET, 3),
        **record,
        "batch": args.batch, "scan_iters": args.scan_iters,
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
