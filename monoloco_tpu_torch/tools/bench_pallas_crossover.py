"""Plain-torch vs hand-written-kernel crossover of the bf16 folded MLP.

Counterpart of the JAX package's `tools/bench_pallas_crossover.py`. For each
(hidden, batch) shape it times the BN-folded Loco MLP forward with bf16
weights through
  - the plain path, `folded_forward` on bf16 tensors (`torch.matmul`, as
    the JAX tool's XLA path), and
  - the K1 kernel, `fused_loco_forward` on bf16-packed weights
    (csrc/wgmma_layer.cu),
each in `scan` calls chained through the data and ended by one checksum
fetch (the bench's methodology), median of 7 after a warm-up. Prints one
JSON line per measurement, the wall per call and inferences/s, and a winner
table; `--out` appends the lines to a file too.

The kernel takes any hidden % 128 == 0; another width is measured on the
plain path only and recorded with the kernel's own refusal, as the JAX tool
records the widths its kernel refuses.

Usage: python -m monoloco_tpu_torch.tools.bench_pallas_crossover
           [--hiddens 256,1024,2048] [--batches 256,4096,65536,131072] [--out F]
"""

import argparse
import json

import numpy as np
import torch

from .. import bench
from ..models import folded_forward
from ..ops import fused_loco_forward, pack_folded_weights

HIDDENS = (256, 1024, 2048)
BATCHES = (256, 4096, 65536, 131072)


def time_fn(fwd, x, length, reps=7):
    """Median seconds of one call of `length` forwards chained through the
    data (the bench's `time_serving`, with the MLP's raw outputs)."""
    return bench.time_serving(lambda v, _: (fwd(v),), x, None, length, reps=reps)[0]


def _ints(text):
    return tuple(int(v) for v in text.split(','))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--hiddens', type=_ints, default=HIDDENS)
    parser.add_argument('--batches', type=_ints, default=BATCHES)
    parser.add_argument('--out', help='also append the JSON lines to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_pallas_crossover measures a CUDA card, and "
                           "torch.cuda.is_available() is false")
    device = torch.cuda.get_device_name(0)
    records = []

    def emit(rec):
        rec['device'] = device
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')

    for hidden in args.hiddens:
        folded = bench.bench_folded(hidden, device='cuda')
        folded_bf16 = bench.tree_map(lambda t: t.to(torch.bfloat16), folded)
        packed = pack_folded_weights(folded, dtype=torch.bfloat16)
        for batch in args.batches:
            # scan length scaled so each timed call is >= ~10 ms of device
            # work even at small batches
            length = max(4, min(256, (1 << 22) // batch))
            x = torch.from_numpy(
                np.random.RandomState(0).randn(batch, 34).astype(np.float32)).cuda()
            wall = time_fn(lambda v: folded_forward(folded_bf16, v.to(torch.bfloat16)).float(),
                           x, length)
            emit(dict(path='xla', hidden=hidden, batch=batch, scan=length,
                      wall_per_dispatch_ms=round(wall * 1e3, 3),
                      inf_per_sec=round(batch * length / wall, 1)))
            try:
                wall = time_fn(lambda v: fused_loco_forward(folded, v, packed=packed,
                                                            tile=min(512, batch)),
                               x, length)
            except ValueError as exc:        # a width the kernel does not take
                emit(dict(path='pallas', hidden=hidden, batch=batch, skipped=str(exc)))
                continue
            emit(dict(path='pallas', hidden=hidden, batch=batch, scan=length,
                      wall_per_dispatch_ms=round(wall * 1e3, 3),
                      inf_per_sec=round(batch * length / wall, 1)))

    print('\nhidden  batch   torch Minf/s  kernel Minf/s  kernel/torch')
    by_key = {(r['hidden'], r['batch'], r['path']): r['inf_per_sec']
              for r in records if 'inf_per_sec' in r}
    for hidden in args.hiddens:
        for batch in args.batches:
            xv = by_key.get((hidden, batch, 'xla'))
            pv = by_key.get((hidden, batch, 'pallas'))
            ratio = f'{pv / xv:.3f}' if (xv and pv) else '-'
            print(f'{hidden:6d} {batch:7d} {xv / 1e6 if xv else 0:12.2f} '
                  f'{pv / 1e6 if pv else 0:13.2f}  {ratio}')
    return records


if __name__ == '__main__':
    main()
