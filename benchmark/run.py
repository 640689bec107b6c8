"""The benchmark of monoloco_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`benchmark/configs/`) and a traffic mix
(`benchmark/traffic/`); the run makes the weights and the frames from the
seed, warms up, measures for S seconds, checks the outputs of sampled
chunks against the plain reference (`benchmark/reference/`) and prints, as
its last line, one JSON object: `correct`, `attempted` (chunks), `failed`,
`metrics` (the end-to-end metrics, or with `--trace 1` the per-layer
ones), `device`, with `--trace 1` `breakdown`, and `checks` (each compared
number beside its limit), which stderr's last lines repeat. Earlier lines
carry the chunk counts, the engine's routing counters and kernel launches,
and the card's power limit.

Exits 2 without a result when no CUDA card (or too few) is found, 3 when a
module of JAX, Flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()   # set-up is measured from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.NoDevice as err:
        print(f'no result: {err}', file=sys.stderr)
        return 2
    except harness.ForbiddenModules as err:
        print(f'no result: {err}', file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
