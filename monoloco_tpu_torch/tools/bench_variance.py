"""Run the port's bench N times in fresh processes and report median +- spread.

Counterpart of the JAX package's `tools/bench_variance.py`: the run-to-run
spread of the one-card throughput number, so that a difference between two
calls can be told apart from noise. Each run is `python -m
monoloco_tpu_torch.bench` in an interpreter of its own (the kernels'
library is built once, by the first run, and loaded by the others), with
the environment passed through, MONOLOCO_TPU_PRECISION included: unset,
the bench measures both serving paths and labels each in its JSON line, and
each path's band is kept apart so that the headline's spread can be
attributed.

    python -m monoloco_tpu_torch.tools.bench_variance [N]

N defaults to 7. Prints every run, then one summary JSON line with the
JAX tool's keys: n (successful runs), median, mean, stdev, min, max,
rel_spread_pct, and per path bf16_median, bf16_spread_pct, int8_dyn_median,
int8_dyn_spread_pct; and n_failed, the runs that failed. Unlike the JAX
tool, which skips a failed run silently, any failed run makes the exit code
non-zero (after the summary). The bench measures a CUDA card, so without
one the tool raises before the first run.
"""

import argparse
import json
import statistics
import subprocess
import sys

from . import REPO

PER_PATH = ('bf16_inferences_per_sec', 'int8_dyn_inferences_per_sec')


def run_bench():
    """One bench run in a fresh interpreter: (its JSON record, or None when
    it failed, and the failure's text)."""
    proc = subprocess.run([sys.executable, '-m', 'monoloco_tpu_torch.bench'],
                          capture_output=True, text=True, cwd=REPO)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{')]
    if proc.returncode != 0 or not line:
        return None, (f'FAILED rc={proc.returncode}\n{proc.stdout[-500:]}'
                      f'\n{proc.stderr[-500:]}')
    return json.loads(line[-1]), ''


def summarize(values, per_path, n_failed):
    """The summary of the runs' headline values and their per-path values,
    rounded as the JAX tool rounds them."""
    summary = {'metric': 'bench_variance', 'n': len(values), 'n_failed': n_failed}
    if len(values) >= 2:
        med = statistics.median(values)
        summary.update(
            median=round(med, 1), mean=round(statistics.mean(values), 1),
            stdev=round(statistics.stdev(values), 1),
            min=round(min(values), 1), max=round(max(values), 1),
            rel_spread_pct=round((max(values) - min(values)) / med * 100.0, 2))
    for key, bucket in per_path.items():
        if len(bucket) >= 2:
            med = statistics.median(bucket)
            summary[key.replace('_inferences_per_sec', '_median')] = round(med, 1)
            summary[key.replace('_inferences_per_sec', '_spread_pct')] = round(
                (max(bucket) - min(bucket)) / med * 100, 2)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('n', nargs='?', type=int, default=7, help='bench runs (default 7)')
    args = parser.parse_args(argv)
    from ..network.engine import default_device
    default_device()                 # raises without a card: the bench measures one
    values, n_failed = [], 0
    per_path = {key: [] for key in PER_PATH}
    device = None
    for i in range(args.n):
        record, failure = run_bench()
        if record is None:
            n_failed += 1
            print(f'run {i}: {failure}', flush=True)
            continue
        device = record.get('device', device)
        values.append(record['value'])
        for key, bucket in per_path.items():
            if key in record:
                bucket.append(record[key])
        extras = ' '.join(f'{k.split("_inferences")[0]}={record[k]:,.0f}'
                          for k in per_path if k in record)
        print(f'run {i}: {record["value"]:,.0f} inferences/sec  {extras}', flush=True)
    summary = summarize(values, per_path, n_failed)
    summary['device'] = device
    print(json.dumps(summary), flush=True)
    if n_failed:
        sys.exit(f'{n_failed} of {args.n} bench runs failed')
    if len(values) < 2:
        sys.exit('not enough successful runs')
    return summary


if __name__ == '__main__':
    main()
