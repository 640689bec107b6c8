"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (no look for a card) at a small size, with
the engine that the window drives wrapped so that it answers wrongly
(`bench_helpers.Broken`: stale outputs, half of a chunk left out, an
answer altered). Each fault is held against a sound run of the same cell,
seed and size, which has to come out correct under the same limits first,
so that a fault's failure is the fault's."""

import io
import time

import pytest

from benchmark import harness, manifest
from benchmark.tests.bench_helpers import Broken, shrink

WORKLOADS = [w['name'] for w in manifest.load()['workloads']]


def _run(workload, seed=77, wrap=None):
    spec = shrink(manifest.resolve(workload), 128, chunk_frames=8, people_mean=4.0,
                  pool_chunks=3, warmup_chunks=1, check_chunks=3)
    if spec['traffic'].get('n_dropout'):
        spec['traffic']['n_dropout'] = 3
    return harness.run(workload, seed, 0.3, False, time.perf_counter(), spec=spec,
                       device='cpu', wrap=wrap, log=io.StringIO())


@pytest.mark.parametrize('fault', Broken.FAULTS)
@pytest.mark.parametrize('workload', WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    sound = _run(workload)
    assert sound['correct'] is True, sound['checks']
    result = _run(workload, wrap=lambda engine: Broken(engine, fault))
    assert result['attempted'] > 0
    assert result['correct'] is False, result['checks']


@pytest.mark.parametrize('seed', [1, 2 ** 31 + 5])
@pytest.mark.parametrize('workload', WORKLOADS)
def test_sound_run_is_correct(workload, seed):
    result = _run(workload, seed)
    assert result['correct'] is True, result['checks']
    assert list(result)[-1] == 'checks'
