"""Bulk localization: a closed loop of chunks through
`Loco.forward_batch_async` and the `finalize()` it returns.

The harness is the user. It feeds the pool's frames in chunks of the
traffic's `chunk_frames`, in order, cycling over the pool, and keeps
`in_flight` chunks dispatched: chunk i + 1 is dispatched before chunk i's
`finalize()`, as GenerateKitti does (`eval/generate_kitti.py`). Each
chunk's latency runs from its `forward_batch_async` call to its
`finalize()` returning. `warmup_chunks` chunks of the pool run the same way
before the window. The window closes `seconds` after its first dispatch:
no chunk is dispatched after that, those in flight are finalized (they are
checked, and counted as attempted, but not timed).

The outputs of `check_chunks` chunks, a uniform sample of every chunk the
window dispatched drawn from the seed (reservoir sampling), are kept for
the comparison after the window.
"""

import contextlib
import gc
import time
import traceback
from collections import deque

import numpy as np


def _arguments(chunk):
    if 'right' in chunk:
        return chunk['left'], chunk['kk'], chunk['right']
    return chunk['left'], chunk['kk']


def run(engine, pool, traffic, seconds, seed, span=None, on_window=None):
    """Drive `engine` over `pool`. `span(name)` is a context manager around
    each step (the traced run's annotations; none by default);
    `on_window()`, called after the warm-up, returns a context manager that
    spans the window and the finalizes after it (the traced run starts its
    profiler there). Returns a dict: 'chunks' (one record a dispatched
    chunk of the window), 'samples' ([(pool index, outputs)]), 'failed',
    'first_error', 't0' (the window's start, perf_counter) and 'seconds'."""
    span = span or (lambda name: contextlib.nullcontext())
    depth = traffic['in_flight']
    n_pool = len(pool)
    failed, errors = [0], []

    def step(fn, *args):
        try:
            return fn(*args)
        except Exception:  # a failing chunk counts as failed; the run goes on
            failed[0] += 1
            if not errors:
                errors.append(traceback.format_exc())
            return None

    def loop(first, t0, record):
        inflight = deque()
        k = first
        while True:
            if t0 is None:
                if k - first >= traffic['warmup_chunks']:
                    break
            elif time.perf_counter() >= t0 + seconds:
                break
            pidx = k % n_pool
            with span('pack'):
                args = _arguments(pool[pidx])
            t_disp = time.perf_counter()
            with span('dispatch'):
                fin = step(engine.forward_batch_async, *args)
            t_back = time.perf_counter()
            inflight.append((k, pidx, t_disp, t_back, fin))
            k += 1
            if len(inflight) >= depth:
                record(inflight.popleft())
        while inflight:
            record(inflight.popleft())

    def finish(item):
        fin = item[4]
        if fin is None:
            return None
        with span('finalize'):
            return step(fin)

    loop(0, None, finish)

    chunks, samples = [], []
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5eed])
    check = traffic['check_chunks']

    def record(item):
        k, pidx, t_disp, t_back, _ = item
        outs = finish(item)
        chunks.append({'k': k, 'pool': pidx, 't_dispatch': t_disp, 't_done': time.perf_counter(),
                       'dispatch_s': t_back - t_disp, 'ok': outs is not None})
        n = len(chunks)
        if n <= check:
            samples.append((pidx, outs))
        else:
            j = int(rng.integers(0, n))
            if j < check:
                samples[j] = (pidx, outs)

    # What set-up left behind is moved out of the collector's way, so that
    # collections in the window scan only what the window makes.
    gc.collect()
    gc.freeze()
    try:
        with (on_window() if on_window else contextlib.nullcontext()):
            t0 = time.perf_counter()
            loop(traffic['warmup_chunks'], t0, record)
    finally:
        gc.unfreeze()
    return {'chunks': chunks, 'samples': samples, 'failed': failed[0],
            'first_error': errors[0] if errors else None, 't0': t0, 'seconds': seconds}
