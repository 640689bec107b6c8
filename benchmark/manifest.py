"""`BENCHMARK.json` and the files its names lead to.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json` (the entry's `file`): widths, the net, `source`,
  `reduced`, `assumed`, and `reference`, the module of `reference/` that
  computes it plainly;
- `traffic/<traffic>.json`: the mix's parameters, the `generator`
  (`generators/<kind>.py`) that makes its frames and the `loop`
  (`loops/<kind>.py`) that feeds them to the program;
- `limits/<workload>.json`: the cell's compared numbers' limits and the
  readings they were set from;
- `metrics/<metric>.py`: one reader a metric, `read(run)` -> a number, or
  None where the run holds nothing to read.
"""

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}\Z')


def load(root=ROOT):
    return json.loads((Path(root) / 'BENCHMARK.json').read_text())


def _json(path):
    return json.loads(Path(path).read_text())


def _for_cell(metrics, workload):
    return [m for m in metrics if workload in m.get('workloads', [workload])]


def resolve(workload, root=ROOT):
    """Everything a run of `workload` needs, by name: a dict with 'cell',
    'config', 'traffic', 'limits', 'end_to_end' and 'per_layer' (the
    metrics the cell reports)."""
    bench = load(root)
    here = Path(root) / BENCH.name
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = {c['name']: c for c in bench['configs']}[cell['config']]
    return {
        'cell': cell,
        'config': _json(Path(root) / entry['file']),
        'traffic': _json(here / 'traffic' / f"{cell['traffic']}.json"),
        'limits': _json(here / 'limits' / f'{workload}.json'),
        'end_to_end': _for_cell(bench['end_to_end'], workload),
        'per_layer': _for_cell(bench['per_layer'], workload),
        'run_seconds': bench['run_seconds'],
    }


def reader_path(metric_name, root=ROOT):
    return Path(root) / BENCH.name / 'metrics' / f'{metric_name}.py'


def reader(metric_name, root=ROOT):
    """The `read(run)` function of a metric's reader file."""
    path = reader_path(metric_name, root)
    spec = importlib.util.spec_from_file_location(
        'benchmark.metrics.' + re.sub(r'\W', '_', metric_name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
