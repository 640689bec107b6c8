"""The trace reduction on a hand-made trace: busy time is the union of the
device's events inside the window, the spans' annotations mirrored on the
device do not count, and each idle gap is named by the host span it fell
in."""

from types import SimpleNamespace

import pytest

from benchmark import trace


class Event:
    def __init__(self, name, device, start, end):
        self._v = (name, device, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[1] else 'DeviceType.CPU'

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def _prof(events):
    results = SimpleNamespace(events=lambda: [Event(*e) for e in events])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_reduce_hand_made_trace():
    ms = 1_000_000
    events = [
        ('window', False, 0, 100 * ms),
        ('dispatch', False, 0, 30 * ms), ('finalize', False, 60 * ms, 70 * ms),
        ('dispatch', True, 0, 30 * ms),                 # annotation on the device: not work
        ('gemm', True, 10 * ms, 40 * ms), ('gemm', True, 20 * ms, 50 * ms),   # overlap: 40 ms
        ('Memcpy HtoD (Pageable -> Device)', True, 80 * ms, 90 * ms),
        ('late', True, 95 * ms, 120 * ms),              # clipped to the window: 5 ms
    ]
    out = trace.reduce(_prof(events))
    assert out['window_s'] == pytest.approx(0.1)
    assert out['busy_s'] == pytest.approx(0.055)
    assert out['kernel_busy_s'] == pytest.approx(0.045)   # copies are not kernels
    assert out['device_ops'][0] == ['gemm', pytest.approx(0.06)]
    gaps = dict(out['idle_gaps'])
    # Idle 0-10 (dispatch), 50-80 (mid 65: finalize), 90-95 (harness).
    assert gaps == {'dispatch': pytest.approx(0.01), 'finalize': pytest.approx(0.03),
                    'harness': pytest.approx(0.005)}


def test_reduce_without_window_or_device_reads_nothing():
    assert trace.reduce(_prof([('dispatch', False, 0, 10)])) is None
    assert trace.reduce(_prof([('window', False, 0, 10)])) is None
