"""The reduction of a torch.profiler trace to device busy time, kernel time
by name and the idle gaps, each named by the benchmark's host span it fell
in.

The harness wraps its window in a `window` span and each chunk's steps in
`pack`, `dispatch` and `finalize` spans (`torch.profiler.record_function`);
host time outside them is the harness's own (`harness`). Device activity is
every CUDA event of the trace (kernels, copies, sets) but the annotations
kineto mirrors onto the device's timeline, which carry the spans' names.
"""

import bisect

SPANS = ('pack', 'dispatch', 'finalize')
WINDOW = 'window'


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), 'cuda' in str(e.device_type()).lower(), start,
                    start + e.duration_ns()))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, top=10):
    """{'window_s', 'busy_s', 'kernel_busy_s', 'device_ops', 'idle_gaps'} of
    the traced window; None when the trace holds no window or no device
    event."""
    events = _events(prof)
    names = set(SPANS) | {WINDOW}
    windows = [(s, e) for n, dev, s, e in events if n == WINDOW and not dev]
    if not windows:
        return None
    w0, w1 = windows[0]
    device, kernels, by_name = [], [], {}
    for name, dev, s, e in events:
        if not dev or name in names:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        device.append((s, e))
        if not name.startswith(('Memcpy', 'Memset')):
            kernels.append((s, e))
        by_name[name] = by_name.get(name, 0) + (e - s)
    if not device:
        return None
    busy = _merge(device)
    spans = sorted((s, e, n) for n, dev, s, e in events if n in SPANS and not dev)
    starts = [s for s, _, _ in spans]
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        span = spans[i][2] if i >= 0 and spans[i][1] >= mid else 'harness'
        idle[span] = idle.get(span, 0) + (g1 - g0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        'window_s': (w1 - w0) * 1e-9,
        'busy_s': sum(e - s for s, e in busy) * 1e-9,
        'kernel_busy_s': sum(e - s for s, e in _merge(kernels)) * 1e-9,
        'device_ops': [[n[:200], t * 1e-9] for n, t in ops],
        'idle_gaps': [[n, t * 1e-9] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])],
    }
