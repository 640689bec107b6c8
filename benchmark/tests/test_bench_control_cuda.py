"""On the card, at each cell's own size: a sound program's compared numbers
hold their limits, the cell's control (`limits/<workload>.json`
`controls`: the program at the precision below, or the reference computed
in it) fails at least one, and so does a whole run with each fault of
`bench_helpers.Broken` planted under its timed path. Skips without a CUDA
card. On the card:
`python -m pytest -q benchmark/tests/test_bench_control_cuda.py`."""

import io
import time

import pytest

from benchmark import check, harness, manifest
from benchmark.tests.bench_helpers import Broken

WORKLOADS = [w['name'] for w in manifest.load()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_fails_and_program_holds(workload):
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from benchmark import readings
    spec = manifest.resolve(workload)
    limits = spec['limits']['limits']
    sides = readings.read_seed(spec, 424242, 2.0, spec['limits']['controls'],
                               torch.device('cuda', 0))
    (side, program), controls = sides[0], sides[1:]
    assert side == 'program'
    assert check.judge(program.values, limits)[0], program.values
    assert controls
    for name, numbers in controls:
        assert not check.judge(numbers.values, limits)[0], (name, numbers.values)


@pytest.mark.cuda
@pytest.mark.parametrize('fault', Broken.FAULTS)
@pytest.mark.parametrize('workload', WORKLOADS)
def test_fault_fails_at_the_cells_size(workload, fault):
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    result = harness.run(workload, 515151 + Broken.FAULTS.index(fault), 2.0, False,
                         time.perf_counter(), wrap=lambda engine: Broken(engine, fault),
                         log=io.StringIO())
    assert result['attempted'] > 0
    assert result['correct'] is False, result['checks']
