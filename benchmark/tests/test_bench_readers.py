"""Each metric's reader on a hand-made run record: the e2e metrics over the
chunks completed in the window, the shares over every chunk of the traced
window and its finalizes, and nothing read where a run holds nothing to
read."""

import pytest

from benchmark import manifest


def _record(trace=None):
    chunks = [{'t_dispatch': 0.0, 't_done': 0.010, 'dispatch_s': 0.002, 'detections': 100,
               'ops': 10e12, 'ok': True, 'in_window': True},
              {'t_dispatch': 0.5, 't_done': 0.530, 'dispatch_s': 0.004, 'detections': 300,
               'ops': 30e12, 'ok': True, 'in_window': True},
              {'t_dispatch': 0.9, 't_done': 1.100, 'dispatch_s': 0.004, 'detections': 900,
               'ops': 90e12, 'ok': True, 'in_window': False}]
    return {'setup_s': 9.5, 'window_s': 1.0, 'chunks': chunks, 'trace': trace,
            'peak_ops_per_s': 100e12, 'peak_name': 'test'}


def read(name, record):
    return manifest.reader(name)(record)


def test_end_to_end_readers():
    rec = _record()
    assert read('detections_per_s', rec) == 400.0
    assert read('chunk_p95_ms', rec) == pytest.approx(10 + 0.95 * 20)
    assert read('setup_s', rec) == 9.5
    assert read('dispatch_host_ms.bulk', rec) == pytest.approx(3.0)


def test_trace_readers():
    rec = _record({'window_s': 2.0, 'busy_s': 1.6, 'kernel_busy_s': 1.5})
    assert read('kernel_roofline_pct.bulk', rec) == pytest.approx(100 * 130e12 / (1.5 * 100e12))
    assert read('mfu_pct.bulk', rec) == pytest.approx(100 * 130e12 / (2.0 * 100e12))
    assert read('device_idle_pct.bulk', rec) == pytest.approx(20.0)


def test_nothing_to_read():
    rec = _record()
    rec['chunks'] = []
    for name in ('detections_per_s', 'chunk_p95_ms', 'dispatch_host_ms.bulk',
                 'kernel_roofline_pct.bulk', 'mfu_pct.bulk', 'device_idle_pct.bulk'):
        assert read(name, rec) is None
