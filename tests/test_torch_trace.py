"""The port's tracer (`utils/trace.py`) and the engine's spans and counters.

Off, nothing is kept and the engine's outputs are the same bit for bit as
on. On (through `enable()` or a torch.profiler session), one chunk of
`forward_batch_async` gives its span tree, children inside their parents
and both roots on one dispatch id, with the row and copy counters of the
batch. Spans keep their thread's parents, the cap drops and counts, the
clock is the profiler's, no span enters the profiler's trace, and the idle
attribution works on a hand-made trace.
"""

import json
import os
import shutil
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from monoloco_tpu_torch import run
from monoloco_tpu_torch.models import init_loco_params
from monoloco_tpu_torch.network import Loco
from monoloco_tpu_torch.utils import trace

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]
N_DROPOUT = 3
# Frames of 3, 5 and 0 left poses (2, 6 and 0 right): 4 images padded, 8 x 8;
# the MLP runs the 36 pairs in one 128-row tile, and the 8 mono detections
# in the 4 x 8 grid's 32 rows, fewer than a tile. No copy blocks the host.
LEFT, RIGHT = (3, 5, 0), (2, 6, 0)
TREE = {'loco.dispatch': None, 'loco.bucket': 'loco.dispatch', 'loco.h2d': 'loco.dispatch',
        'loco.launch': 'loco.dispatch', 'loco.finalize': None, 'loco.wait': 'loco.finalize',
        'loco.d2h': 'loco.finalize', 'loco.unpack': 'loco.finalize'}
# (rows_useful, rows_run, h2d_copies, d2h_copies) of the batch.
COUNTS = {'stereo': (3 * 2 + 5 * 6, 128, 0, 0),
          'mono_mc': ((3 + 5) * (1 + N_DROPOUT), 4 * 8 * (1 + N_DROPOUT), 0, 0)}


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _keypoints(m, seed):
    rng = np.random.RandomState(seed)
    kps = rng.rand(m, 3, 17).astype(np.float32)
    kps[:, 0] = kps[:, 0] * 800 + 200
    kps[:, 1] = kps[:, 1] * 200 + 80
    kps[:, 2] = 0.8
    return kps


@pytest.fixture(scope='module')
def engines():
    return {'stereo': Loco(init_loco_params(1, 68, 10, 64, 2), mode='stereo', device='cpu'),
            'mono_mc': Loco(init_loco_params(2, 34, 9, 64, 2), mode='mono', device='cpu',
                            n_dropout=N_DROPOUT)}


def _chunk(engine, kind):
    left = [_keypoints(m, i) if m else None for i, m in enumerate(LEFT)]
    kks = [KK] * len(LEFT)
    if kind == 'stereo':
        right = [_keypoints(r, 10 + i) if r else None for i, r in enumerate(RIGHT)]
        return engine.forward_batch_async(left, kks, right)()
    return engine.forward_batch_async(left, kks)()


def _arrays(outs):
    for out in outs:
        if out is None:
            yield None
            continue
        for key in sorted(out):
            for arr in (out[key] if key == 'yaw' else (out[key],)):
                yield key, np.asarray(arr)


def test_off_is_the_shared_no_op_and_keeps_nothing(engines):
    span = trace.span('loco.x', rows=1)
    assert span is trace.OFF and not span and span.dispatch is None
    with span as inner:
        inner.set(rows=2)
    _chunk(engines['stereo'], 'stereo')
    assert trace.records() == [] and trace.dropped() == 0


@pytest.mark.parametrize('kind', ['stereo', 'mono_mc'])
def test_outputs_are_bit_identical_on_and_off(engines, kind):
    off = list(_arrays(_chunk(engines[kind], kind)))
    trace.enable()
    on = list(_arrays(_chunk(engines[kind], kind)))
    assert trace.records()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        if a is None:
            assert b is None
            continue
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])


def _traced_chunk(engine, kind, how):
    if how == 'enable':
        trace.enable()
        _chunk(engine, kind)
        trace.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            _chunk(engine, kind)
    return trace.records()


@pytest.mark.parametrize('how', ['enable', 'profiler'])
@pytest.mark.parametrize('kind', ['stereo', 'mono_mc'])
def test_one_chunk_gives_the_span_tree_and_counters(engines, kind, how):
    recs = _traced_chunk(engines[kind], kind, how)
    by_name = {r['name']: r for r in recs}
    assert sorted(by_name) == sorted(TREE) and len(recs) == len(TREE)
    by_id = {r['id']: r for r in recs}
    for r in recs:
        parent = by_id.get(r['parent'])
        assert (None if parent is None else parent['name']) == TREE[r['name']]
        assert r['start_ns'] <= r['end_ns']
        if parent is not None:
            assert parent['start_ns'] <= r['start_ns'] and r['end_ns'] <= parent['end_ns']
    dispatch, fin = by_name['loco.dispatch'], by_name['loco.finalize']
    assert {r['dispatch'] for r in recs} == {dispatch['id']}
    assert dispatch['end_ns'] <= fin['start_ns']
    useful, ran, h2d, d2h = COUNTS[kind]
    assert dispatch['attrs'] == {'rows_useful': useful, 'rows_run': ran, 'h2d_copies': h2d}
    assert fin['attrs'] == {'d2h_copies': d2h}
    assert h2d + d2h == 0
    assert trace.counters(recs) == {'rows_useful': useful, 'rows_run': ran,
                                    'h2d_copies': h2d, 'd2h_copies': d2h}
    for r in recs:
        if r['name'] not in ('loco.dispatch', 'loco.finalize'):
            assert r['attrs'] == {}


def test_spans_of_two_threads_keep_their_own_parents():
    trace.enable()
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with trace.span(f'outer.{tag}'):
            barrier.wait()              # both outers are open before any inner
            with trace.span(f'inner.{tag}'):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in 'ab']
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {r['name']: r for r in trace.records()}
    for tag in 'ab':
        outer, inner = by_name[f'outer.{tag}'], by_name[f'inner.{tag}']
        assert outer['parent'] is None and outer['dispatch'] == outer['id']
        assert inner['parent'] == outer['id'] and inner['dispatch'] == outer['id']


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, 'CAP', 50)
    trace.enable()
    n_threads, n_spans = 8, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with trace.span('s'):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(trace.records()) == 50
    assert trace.dropped() == n_threads * n_spans - 50
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_spans_are_on_the_profilers_clock():
    """A span wrapping a profiler range holds it, within 100 us: the two
    clocks agree (monotonic clocks would be years apart)."""
    slack = 100_000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('wrap'):
            with record_function('probe'):
                torch.ones(64).sum()
    (span,) = trace.records()
    (probe,) = [e for e in prof.profiler.kineto_results.events() if e.name() == 'probe']
    p0, p1 = probe.start_ns(), probe.start_ns() + probe.duration_ns()
    assert span['start_ns'] <= p0 + slack and p1 <= span['end_ns'] + slack
    assert p0 <= span['end_ns'] + slack and span['start_ns'] <= p1 + slack


def test_no_span_enters_the_profilers_trace(engines):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunk(engines['stereo'], 'stereo')
        _chunk(engines['mono_mc'], 'mono_mc')
    assert len(trace.records()) == 2 * len(TREE)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not [n for n in names if n.startswith('loco.')]


class Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[1] else 'DeviceType.CPU'

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]


def _prof(events):
    results = SimpleNamespace(events=lambda: [Event(*e) for e in events])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _rec(name, start, end, id_, parent=None):
    return {'id': id_, 'parent': parent, 'dispatch': id_ if parent is None else parent,
            'name': name, 'start_ns': start, 'end_ns': end, 'attrs': {}}


def test_idle_by_span_on_a_hand_made_trace():
    ms = 1_000_000
    events = [
        ('aten::mm', False, 0, 100 * ms),
        ('window', False, 0, 100 * ms, True),
        ('window', True, 0, 100 * ms, True),            # annotation mirrored: not work
        ('dispatch', True, 0, 100 * ms),                # mirror of a host range: not work
        ('dispatch', False, 1 * ms, 2 * ms, True),
        ('gemm', True, 10 * ms, 40 * ms), ('gemm', True, 20 * ms, 50 * ms),
        ('Memcpy HtoD (Pageable -> Device)', True, 80 * ms, 90 * ms),
    ]
    spans = [_rec('loco.dispatch', 0, 30 * ms, 1), _rec('loco.h2d', 2 * ms, 8 * ms, 2, 1),
             _rec('loco.finalize', 55 * ms, 75 * ms, 3), _rec('loco.d2h', 60 * ms, 75 * ms, 4, 3)]
    # Idle 0-10 (mid 5: h2d), 50-80 (mid 65: d2h), 90-100 (mid 95: outside).
    out = trace.idle_by_span(_prof(events), spans)
    assert out == {'loco.d2h': pytest.approx(0.03), 'loco.h2d': pytest.approx(0.01),
                   'outside': pytest.approx(0.01)}
    assert list(out) == ['loco.d2h', 'loco.h2d', 'outside']
    assert trace.idle_by_span(_prof(events[:2]), spans) == {}


def test_idle_by_span_takes_the_innermost_span_of_any_thread():
    ms = 1_000_000
    events = [('k', True, 0, 10 * ms), ('k', True, 20 * ms, 30 * ms),
              ('k', True, 40 * ms, 50 * ms), ('k', True, 60 * ms, 70 * ms)]
    spans = [_rec('a.outer', 5 * ms, 65 * ms, 1), _rec('b.root', 12 * ms, 45 * ms, 2),
             _rec('a.inner', 31 * ms, 39 * ms, 3, 1)]
    # Gaps' midpoints 15 (b.root opened last), 35 (a.inner), 55 (a.outer).
    assert trace.idle_by_span(_prof(events), spans) == {
        'b.root': pytest.approx(0.01), 'a.inner': pytest.approx(0.01),
        'a.outer': pytest.approx(0.01)}


def test_predict_profile_writes_the_spans(tmp_path):
    """Three images forward as one batched chunk: the spans file holds its
    spans on the Chrome trace's clock, the summed counters, and an empty
    idle table (no device on the CPU)."""
    root = tmp_path / 'imgs'
    root.mkdir()
    for i in range(3):
        dst = root / f'im{i}.png'
        shutil.copy(os.path.join(HERE, 'fixture_002282.png'), dst)
        shutil.copy(os.path.join(HERE, 'fixture_002282.pifpaf.json'), f'{dst}.pifpaf.json')
    imgs = sorted(str(p) for p in root.glob('*.png'))
    run.main(['predict', *imgs, '--model', MODEL, '--output_types', 'json', '--disable-cuda',
              '-o', str(tmp_path / 'out'), '--profile', str(tmp_path / 'prof')])
    with open(tmp_path / 'prof' / 'predict_spans.json') as f:
        spans = json.load(f)
    with open(tmp_path / 'prof' / 'predict_trace.json') as f:
        chrome = json.load(f)
    names = sorted(r['name'] for r in spans['spans'])
    assert names == sorted(TREE)
    assert spans['clock'] == 'time.time_ns' and spans['idle_by_span_s'] == {}
    assert set(spans['counters']) == {'rows_useful', 'rows_run', 'h2d_copies', 'd2h_copies'}
    assert spans['counters']['h2d_copies'] == 0
    # The Chrome trace's `ts` counts microseconds from `baseTimeNanoseconds`
    # on the spans' clock: the batched chunk lies inside the traced run.
    base = chrome['baseTimeNanoseconds']
    ts = [base + e['ts'] * 1e3 for e in chrome['traceEvents'] if 'ts' in e]
    assert min(ts) - 1e6 <= min(r['start_ns'] for r in spans['spans'])
    assert max(r['end_ns'] for r in spans['spans']) <= max(ts) + 1e6
