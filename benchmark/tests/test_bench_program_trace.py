"""The program's spans and counters as the benchmark reads them: the
dispatch counters of every chunk of each traffic's pool are the yardstick's
rows (`flops.py`), a traced run on the CPU prints the eight metrics that
read them, the readers read only the window's dispatches, and a program
without the tracer leaves them silent."""

import io
import math
import sys
import time

import pytest
import torch

from benchmark import flops, harness, manifest
from benchmark.loops.bulk_chunks import _arguments
from benchmark.tests.bench_helpers import shrink
from monoloco_tpu_torch.utils import trace

WORKLOADS = [w['name'] for w in manifest.load()['workloads']]
SPAN_METRICS = {'bucket_ms.bulk': 'loco.bucket', 'h2d_ms.bulk': 'loco.h2d',
                'launch_ms.bulk': 'loco.launch', 'wait_ms.bulk': 'loco.wait',
                'd2h_ms.bulk': 'loco.d2h', 'unpack_ms.bulk': 'loco.unpack'}
COUNTER_METRICS = ('rows_useful_pct.bulk', 'blocking_copies.bulk')


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _spec(workload, **traffic):
    spec = shrink(manifest.resolve(workload), 32, chunk_frames=8, people_mean=6.0,
                  pool_chunks=4, warmup_chunks=1, check_chunks=2, **traffic)
    if spec['traffic'].get('n_dropout'):
        spec['traffic']['n_dropout'] = 3
    return spec


@pytest.mark.parametrize('workload', WORKLOADS)
def test_dispatch_counters_are_the_yardsticks_rows(workload):
    spec = _spec(workload)
    dev = torch.device('cpu')
    pool, weights = harness.prepare(spec, 2 ** 31 + 11, dev)
    engine = harness.build_engine(spec, weights, dev)
    n_drop = spec['traffic'].get('n_dropout', 0)
    trace.enable()
    for chunk in pool:
        engine.forward_batch_async(*_arguments(chunk))()
    trace.disable()
    roots = [r for r in trace.records() if r['name'] == 'loco.dispatch']
    assert len(roots) == len(pool)
    for chunk, root in zip(pool, roots):
        assert root['attrs']['rows_useful'] == flops.useful_rows(chunk, n_drop)
        assert root['attrs']['rows_run'] == flops.padded_rows(chunk, n_drop)


@pytest.mark.parametrize('workload', WORKLOADS)
def test_a_traced_cpu_run_prints_the_eight_metrics(workload):
    spec = _spec(workload)
    result = harness.run(workload, 5, 0.3, True, time.perf_counter(), spec=spec,
                         device='cpu', log=io.StringIO())
    metrics = result['metrics']
    for name in (*SPAN_METRICS, *COUNTER_METRICS):
        assert name in metrics, sorted(metrics)
        assert math.isfinite(metrics[name]['value']) and metrics[name]['value'] >= 0, name
    assert 0 < metrics['rows_useful_pct.bulk']['value'] <= 100
    stereo = spec['config']['mode'] == 'stereo'
    assert metrics['blocking_copies.bulk']['value'] == (15 if stereo else 12)
    assert result['correct'] is True, result['checks']


def _rec(id_, name, start_ms, end_ms, parent=None, dispatch=None, **attrs):
    return {'id': id_, 'parent': parent, 'dispatch': dispatch or id_, 'name': name,
            'start_ns': int(start_ms * 1e6), 'end_ns': int(end_ms * 1e6), 'attrs': attrs}


def _chunk_records(first_id, t, useful, ran):
    d, f = first_id, first_id + 4
    return [
        _rec(d + 1, 'loco.bucket', t, t + 1, d, d), _rec(d + 2, 'loco.h2d', t + 1, t + 3, d, d),
        _rec(d + 3, 'loco.launch', t + 3, t + 6, d, d),
        _rec(d, 'loco.dispatch', t, t + 6, rows_useful=useful, rows_run=ran, h2d_copies=4),
        _rec(f + 1, 'loco.wait', t + 7, t + 9, f, d), _rec(f + 2, 'loco.d2h', t + 9, t + 13, f, d),
        _rec(f + 3, 'loco.unpack', t + 13, t + 14, f, d),
        _rec(f, 'loco.finalize', t + 7, t + 14, dispatch=d, d2h_copies=11)]


def test_readers_read_the_windows_dispatches_only(monkeypatch):
    """An earlier session's chunk (1 row of 1) is left out: the window is
    the last dispatch roots, one a chunk of the run record."""
    old = _chunk_records(1000, 0, 1, 1)
    window = _chunk_records(10, 100, 30, 100) + _chunk_records(20, 200, 10, 100)
    monkeypatch.setattr(trace, 'records', lambda: old + window)
    run = {'chunks': [{}, {}]}
    expect = {'bucket_ms.bulk': 1.0, 'h2d_ms.bulk': 2.0, 'launch_ms.bulk': 3.0,
              'wait_ms.bulk': 2.0, 'd2h_ms.bulk': 4.0, 'unpack_ms.bulk': 1.0,
              'rows_useful_pct.bulk': 20.0, 'blocking_copies.bulk': 15.0}
    for name, value in expect.items():
        assert manifest.reader(name)(run) == pytest.approx(value), name
    for name in expect:
        assert manifest.reader(name)({'chunks': []}) is None


def test_readers_are_silent_without_the_tracer(monkeypatch):
    """A program that has no `utils/trace.py` (the commit before it) gives
    no reading and no error."""
    import monoloco_tpu_torch.utils
    monkeypatch.delattr(monoloco_tpu_torch.utils, 'trace')
    monkeypatch.setitem(sys.modules, 'monoloco_tpu_torch.utils.trace', None)
    run = {'chunks': [{}, {}]}
    for name in (*SPAN_METRICS, *COUNTER_METRICS):
        assert manifest.reader(name)(run) is None
