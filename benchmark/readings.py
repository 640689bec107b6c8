"""The readings a cell's limits are set from: the compared numbers of sound
runs of the program on many seeds, and of its controls, one process.

    python3 benchmark/readings.py --workload NAME --seeds 1,2,3 [--seconds 3]
        [--controls] [--out FILE]

For each seed: the weights, the frames and the program as a run makes
them, a short window at the cell's own load (`--seconds`, which samples as
many chunks as a run: the traffic's `check_chunks`), and the comparison.
With `--controls`, each control that `limits/<workload>.json` lists runs on
the same seed: `{"program": PRECISION}` is the program built at another
`MONOLOCO_TPU_PRECISION` driven the same way; `{"reference": MODE}` is the
reference computed in MODE (`reference/loco_mlp.py` `mlp`) put in the
program's place on the same sampled chunks. One JSON line per reading, on
stdout and appended to `--out`. A benchmark run never runs this: it reads
the limits.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def numbers_of(spec, weights, pool, samples, device, ref_mode, outputs=None):
    from benchmark import check
    cfg, traffic = spec['config'], spec['traffic']
    numbers = check.Numbers('counts_r' in pool[0], traffic.get('n_dropout', 0) > 0)
    for pidx, outs in samples:
        outs = outputs(pool[pidx]) if outputs else outs
        check.compare_chunk(cfg, traffic, weights, pool[pidx], outs, device, numbers, ref_mode)
    return numbers


def read_seed(spec, seed, seconds, controls, device):
    """[(side, numbers dict)] for one seed."""
    import torch
    from benchmark import check, harness
    traffic = spec['traffic']
    ref_mode = spec['limits'].get('reference', 'f32')
    harness.set_environment(traffic)
    pool, weights = harness.prepare(spec, seed, device)

    def drive(precision):
        os.environ['MONOLOCO_TPU_PRECISION'] = precision
        engine = harness.build_engine(spec, weights, device)
        window, _ = harness.drive(spec, engine, pool, seconds, seed, False, device)
        del engine
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        return window

    window = drive(traffic['precision'])
    out = [('program', numbers_of(spec, weights, pool, window['samples'], device, ref_mode))]
    for control in controls:
        if 'program' in control:
            win = drive(control['program'])
            nums = numbers_of(spec, weights, pool, win['samples'], device, ref_mode)
        else:
            mode = control['reference']
            nums = numbers_of(spec, weights, pool, window['samples'], device, ref_mode,
                              outputs=lambda chunk, m=mode: check.reference_outputs(
                                  spec['config'], traffic, weights, chunk, device, m))
        out.append((json.dumps(control, sort_keys=True), nums))
    os.environ['MONOLOCO_TPU_PRECISION'] = traffic['precision']
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True, help='comma-separated')
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--controls', action='store_true')
    parser.add_argument('--controls-seeds', type=int, default=None,
                        help='run the controls on the first N seeds only')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, manifest
    spec = manifest.resolve(args.workload)
    device = harness._device(spec['cell']['chips'])
    controls = spec['limits'].get('controls', []) if args.controls else []
    seeds = [int(s) for s in args.seeds.split(',')]
    for i, seed in enumerate(seeds):
        start = time.perf_counter()
        use = controls if args.controls_seeds is None or i < args.controls_seeds else []
        for side, nums in read_seed(spec, seed, args.seconds, use, device):
            line = json.dumps({'workload': args.workload, 'seed': seed, 'side': side,
                               'numbers': nums.values, 'raw_err_channel': nums.raw_err_channel,
                               'epi_worst': nums.epi_worst,
                               'frames': nums.frames,
                               'detections': nums.detections,
                               'seconds': time.perf_counter() - start})
            print(line, flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
