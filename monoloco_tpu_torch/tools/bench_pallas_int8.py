"""End-to-end serving throughput of the MLP variants: plain torch vs the
hand-written CUDA kernels, bf16 vs int8.

Counterpart of the JAX package's `tools/bench_pallas_int8.py`, with its six
variant names so that the records line up. Here `xla-*` means plain torch
(what XLA runs in the JAX package) and `pallas-*` means the hand-written
CUDA kernel that replaces the Pallas one:

  xla-bf16     bf16 weights and activations, `torch.matmul`
  xla-int8     static int8 in plain torch (ops/quant.py `quantized_forward`)
  pallas-bf16  K1 with bf16 weights (csrc/wgmma_layer.cu)
  pallas-w8    K5, weight-only int8 (csrc/wgmma_layer.cu)
  pallas-dyn8  K2/K3, per-row dynamic int8: what MONOLOCO_TPU_PRECISION=int8
               serves (csrc/wgmma_layer_kmajor.cu, s8 layers)
  pallas-int8  K4, static-calibrated a8w8, not parity-grade
               (csrc/wgmma_layer_kmajor.cu, static s8 layers)
  pallas-f32   K1 with f32 weights (csrc/wgmma_layer_kmajor.cu, 3xTF32
               layers); not in the default list (the JAX tool has no f32
               variant), measured when named

Each variant times the full serving program of monoloco_tpu_torch.bench
(K^-1 normalize -> MLP -> decode, `scan_iters` chained iterations, one
checksum fetch, median of 5) at 131072 rows, hidden 1024, 3 stages, and
prints one JSON line with its kernel launches.

Usage: python -m monoloco_tpu_torch.tools.bench_pallas_int8 [variants ...]
           [--batch N] [--scan-iters N]
"""

import argparse
import functools
import json

import torch

from .. import bench
from ..ops import (fused_loco_forward, fused_loco_forward_w8, launches, pack_folded_weights,
                   pack_folded_weights_w8)

VARIANTS = ('xla-bf16', 'xla-int8', 'pallas-bf16', 'pallas-w8', 'pallas-dyn8', 'pallas-int8')
EXTRA_VARIANTS = ('pallas-f32',)
# The JAX tool's tile; the CUDA kernels take it and keep their own tiles.
TILE = 512
# The variants that are bench legs, by the bench's names for them.
_BENCH_LEGS = {'xla-bf16': 'bf16', 'xla-int8': 'int8-xla', 'pallas-dyn8': 'int8',
               'pallas-int8': 'int8-a8'}


def build_mlps(folded):
    """variant -> mlp(inputs (m, 34) f32) -> raw (m, 9) f32, with every
    weight pack made once, on the folded tensors' device. The bench legs
    pack as the bench does (the xla-bf16 baseline stores bf16 weights too)."""
    mlps = {}
    for variant, leg in _BENCH_LEGS.items():
        weights, mlp = bench.build_mlp(folded, leg)
        mlps[variant] = functools.partial(mlp, weights)
    packed_bf16 = pack_folded_weights(folded, dtype=torch.bfloat16)
    packed_f32 = pack_folded_weights(folded, dtype=torch.float32)
    packed_w8 = pack_folded_weights_w8(folded)
    mlps.update({
        'pallas-bf16': lambda x: fused_loco_forward(None, x, packed=packed_bf16, tile=TILE),
        'pallas-f32': lambda x: fused_loco_forward(None, x, packed=packed_f32, tile=TILE),
        'pallas-w8': lambda x: fused_loco_forward_w8(packed_w8, x, tile=TILE),
    })
    return mlps


def measure_variant(variant, mlp, keypoints, kk, scan_iters):
    """One variant's JSON record (throughput, median, warm-up seconds,
    checksum, kernel launches)."""
    before = dict(launches)
    median_s, checksum, warm_s = bench.time_serving(
        lambda kps, k: bench.serve_once(lambda _w, x: mlp(x), None, kps, k),
        keypoints, kk, scan_iters)
    if checksum != checksum:
        raise RuntimeError(f"nan checksum ({variant})")
    batch = keypoints.shape[0]
    return {
        'variant': variant,
        'inferences_per_sec': round(batch * scan_iters / median_s, 1),
        'median_s': round(median_s, 4),
        'compile_s': round(warm_s, 1),
        'batch': batch, 'scan_iters': scan_iters, 'tile': TILE,
        'checksum': checksum,
        'launches': {k: v - before[k] for k, v in launches.items() if v != before[k]},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('variants', nargs='*',
                        help=f"any of {', '.join(VARIANTS + EXTRA_VARIANTS)} "
                             f"(default: the first six)")
    parser.add_argument('--batch', type=int, default=bench.BATCH)
    parser.add_argument('--scan-iters', type=int, default=bench.SCAN_ITERS)
    args = parser.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS + EXTRA_VARIANTS))
    if unknown:
        parser.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_pallas_int8 measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    folded = bench.bench_folded(device='cuda')
    mlps = build_mlps(folded)
    keypoints, kk = bench.bench_keypoints(args.batch, 'cuda')
    device = torch.cuda.get_device_name(0)
    records = []
    for variant in args.variants or VARIANTS:
        rec = measure_variant(variant, mlps[variant], keypoints, kk, args.scan_iters)
        rec['device'] = device
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == '__main__':
    main()
