"""Spans and counters of the port's host work, on the clock of
torch.profiler's events.

    with trace.span('loco.dispatch') as sp:
        ...
        if sp:                       # counters only when tracing is on
            sp.set(rows_run=n)

Tracing is on while a torch.profiler session records (checked at every
span) or between `enable()` and `disable()`. Off, `span()` returns one
shared object that does nothing and is false: nothing is stamped, counted
or kept.

On, each span, when it closes, keeps one record: {'id', 'parent',
'dispatch', 'name', 'start_ns', 'end_ns', 'attrs'}. The parent is the
innermost span open on the same thread when it opened (None for a root).
The dispatch id ties the spans of one dispatch together: it is given
(`dispatch=`), or the parent's, or a root's own id. Times are
`time.time_ns()`, the clock that torch.profiler's kineto events carry, so
each span can be set against the device's trace (`idle_by_span`). The spans
are not `record_function` ranges and never appear in the profiler's trace.

Records stay in memory, in one list of at most CAP; those past the cap are
counted (`dropped()`) and not kept. Nothing is written to a file here.

The engine's spans and counters are listed in `Loco.forward_batch_async`'s
docstring (network/engine.py). Its copy counters, `h2d_copies` on
`loco.dispatch` and `d2h_copies` on `loco.finalize`, count the copies that
block the host on the device: 0 on every device, where the copies go
through one host block each way and never block.
"""

import heapq
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

CAP = 1 << 20
OUTSIDE = 'outside'

_records = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_enabled = False
_dropped = 0


class _Off:
    """The span of tracing off: does nothing and is false."""

    __slots__ = ()
    dispatch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(record):
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(record)
        else:
            _dropped += 1


class _Span:
    __slots__ = ('id', 'parent', 'dispatch', 'name', 'attrs', 'start_ns')

    def __init__(self, name, dispatch, attrs):
        self.name, self.dispatch, self.attrs = name, dispatch, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.dispatch is None:
            self.dispatch = self.id if top is None else top.dispatch
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _stack().pop()
        _keep({'id': self.id, 'parent': self.parent, 'dispatch': self.dispatch,
               'name': self.name, 'start_ns': self.start_ns, 'end_ns': end_ns,
               'attrs': self.attrs})
        return False

    def set(self, **attrs):
        """Counters of the span, kept as its attributes."""
        self.attrs.update(attrs)


def span(name, dispatch=None, **attrs):
    """A context manager timing its block as the span `name`, with `attrs`
    as its first attributes; the shared no-op `OFF` when tracing is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return OFF
    return _Span(name, dispatch, attrs)


def enable():
    """Trace without a profiler session, until `disable()`."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def records():
    """The kept records, oldest first (a copy of the list)."""
    with _lock:
        return list(_records)


def dropped():
    """How many records the cap turned away since the last `reset()`."""
    return _dropped


def reset():
    """Forget every record and the count of those dropped."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def counters(spans):
    """Each counter summed over `spans` (records)."""
    out = {}
    for rec in spans:
        for key, value in rec['attrs'].items():
            out[key] = out.get(key, 0) + value
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_by_span(prof, spans=None):
    """{span name: seconds} of a stopped `torch.profiler.profile`'s device
    idle time, largest first. Device idle is every gap, between the trace's
    first and last event, in the union of its CUDA-typed events, user
    annotations and their mirrors on the device excluded (kernels, copies
    and sets remain). Each gap is put down to the innermost of `spans`
    (default: `records()`) open at its midpoint, the one opened last, or to
    'outside' when none was. Empty when the trace holds no device event."""
    spans = records() if spans is None else spans
    events = list(prof.profiler.kineto_results.events())
    if not events:
        return {}
    annotations = {e.name() for e in events if e.is_user_annotation()}
    device = []
    for e in events:
        if 'cuda' in str(e.device_type()).lower() and e.name() not in annotations:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if not device:
        return {}
    t0 = min(e.start_ns() for e in events)
    t1 = max(e.start_ns() + e.duration_ns() for e in events)
    edges = [t0] + [x for iv in _merge(device) for x in iv] + [t1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    # Sweep the gaps' midpoints in order: `open_` holds the spans begun by
    # then, latest start first; one that ended before a midpoint ends before
    # every later one too, so it leaves for good.
    ordered = sorted(spans, key=lambda r: r['start_ns'])
    open_, i, idle = [], 0, {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(ordered) and ordered[i]['start_ns'] <= mid:
            rec = ordered[i]
            heapq.heappush(open_, (-rec['start_ns'], i, rec['end_ns'], rec['name']))
            i += 1
        while open_ and open_[0][2] < mid:
            heapq.heappop(open_)
        name = open_[0][3] if open_ else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))
