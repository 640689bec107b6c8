"""The engine's staged copies on a card (`_Staging` and `_HostCopy` in
network/engine.py): the padded arrays go in from one pinned block and the
outputs come back into one pinned buffer behind the dispatch's own event.

Marked `cuda`: without a CUDA device every test skips (pinned memory and
CUDA events need a card). This file imports neither jax nor the JAX
package, so it runs on the GPU machine, where jax is not installed; run it
there with
    python -m pytest --noconftest tests/test_torch_staged_cuda.py
Each case is a MonStereo engine at int8 (dyn8), bfloat16 (K1-bf16) or
float32, or MonoLoco++ with 10 MC-dropout passes at float32, at hidden
1024 and 3 stages, on crowd chunks (64 frames, Poisson 22.64 people, as
tests/torch_stereo_grid.py makes them) and, stereo, its edge mixes.
Checked: the dispatch never synchronizes (sync debug mode 'error'); the
outputs are the padded-grid evaluation's (tests/torch_stereo_grid.py,
tests/torch_mono_grid.py), bit for bit where the kernel computes each row
alone (dyn8, K1-bf16), else within f32 tolerance, and own their memory; a chunk's results survive later chunks
that reuse its buffers; closures finalize in any order, on another
thread, or never, and their pinned buffers go back to the engine's staging
pool; a repeated loop of chunks makes no new pinned allocation after its
warm-up. MonoLoco++ with MC runs one row a real detection
(`engine._flat_rows`): on the edge mixes of tests/torch_mono_grid.py and a
crowd chunk its outputs and epi match the padded (B, m) grid within f32
tolerance, without a sync, and its pinned output holds the flat rows.
"""

import copy
import gc
import threading
from collections import deque

import numpy as np
import pytest
import torch

import torch_mono_grid as mono_grid
import torch_stereo_grid as grid
from monoloco_tpu_torch.models import init_loco_params
from monoloco_tpu_torch.network import Loco, engine

pytestmark = pytest.mark.cuda

CASES = ('int8', 'bfloat16', 'float32', 'mc')
# The flat dispatches against the padded grid: f32 on both sides (TF32
# off); cuBLAS may sum in another order at another row count.
F32_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: pinned memory and CUDA events')
    return torch.device('cuda')


def _engine(case, device, monkeypatch):
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'float32' if case == 'mc' else case)
    if case == 'mc':
        net = Loco(_mc_weights(), mode='mono', device=device, n_dropout=10)
    else:
        params, bn = init_loco_params(2, 68, 10, 1024, 3)
        params['w_fin']['b'][0:3] += torch.tensor([np.pi / 2, np.pi / 2, 15.0])
        net = Loco((params, bn), mode='stereo', device=device)
    return net


def _chunks(case, mixes=False):
    """Four crowd chunks and, with `mixes` for stereo, the edge mixes."""
    chunks = [grid.crowd(64, seed=s) for s in range(4)]
    if case == 'mc':
        return [(left, kks) for left, kks, _ in chunks]
    if mixes:
        chunks += [grid.frames(spec, seed=i) for i, spec in enumerate(grid.MIXES.values())]
    return chunks


def _flat(outs):
    """(image, key, index) and array (or epi's list of zeros) of every output,
    in order."""
    for i, out in enumerate(outs):
        if out is None:
            yield (i, None, None), None
            continue
        for key, value in out.items():
            for j, arr in enumerate(value if key == 'yaw' else (value,)):
                yield (i, key, j), arr


def _assert_identical(outs, refs):
    got, ref = list(_flat(outs)), list(_flat(refs))
    assert [name for name, _ in got] == [name for name, _ in ref]
    for (name, a), (_, b) in zip(got, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=str(name))
        else:
            assert a == b, name


def _assert_own_memory(outs):
    for name, arr in _flat(outs):
        if isinstance(arr, np.ndarray):
            assert not torch.from_numpy(arr).is_pinned(), name


def _run(net, chunks, depth=2):
    """The bench loop's order: `depth` chunks in flight."""
    pending, outs = deque(), []
    for chunk in chunks:
        pending.append(net.forward_batch_async(*chunk))
        if len(pending) >= depth:
            outs.append(pending.popleft()())
    while pending:
        outs.append(pending.popleft()())
    return outs


def _host_stats():
    stats = getattr(torch.cuda.memory, 'host_memory_stats', None)
    if stats is None or 'num_host_alloc' not in stats():
        pytest.skip('this torch has no host_memory_stats with num_host_alloc')
    return stats


@pytest.mark.parametrize('case', CASES)
def test_the_dispatch_never_synchronizes(cuda_device, monkeypatch, case):
    """Under sync debug mode 'error' a steady dispatch raises nothing: no
    blocking copy in, no info check of K^-1, no copy out. Its finalize makes
    at most one synchronization, on its own event."""
    import warnings
    net = _engine(case, cuda_device, monkeypatch)
    chunk = _chunks(case)[0]
    net.forward_batch(*chunk)                  # builds and warms every kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fin = net.forward_batch_async(*chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            outs = fin()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if 'called a synchronizing' in str(w.message)]
    assert len(syncs) <= 1, syncs
    assert sum(o is not None for o in outs) == sum(len(k) > 0 for k in chunk[0])


@pytest.mark.parametrize('case', CASES)
def test_staged_outputs_are_the_blocking_paths_bit_for_bit(cuda_device, monkeypatch, case):
    """The outputs of every chunk are the padded grid's: bit for bit under
    dyn8 and K1-bf16, within f32 tolerance where cuBLAS may sum in another
    order at another row count."""
    net = _engine(case, cuda_device, monkeypatch)
    for chunk in _chunks(case, mixes=True):
        outs = net.forward_batch(*chunk)
        if case == 'mc':
            mono_grid.assert_close(outs, mono_grid.padded_grid(net, *chunk), F32_RTOL, F32_RTOL)
        else:
            grid.assert_same(outs, grid.padded_grid(net, *chunk),
                             exact=case != 'float32', tol=F32_RTOL)
        _assert_own_memory(outs)


@pytest.mark.parametrize('case', CASES)
def test_a_chunks_results_survive_three_later_chunks(cuda_device, monkeypatch, case):
    """Later chunks of the same buckets reuse the pinned blocks; the first
    chunk's results, finalized before them, do not change."""
    net = _engine(case, cuda_device, monkeypatch)
    chunks = _chunks(case)
    first = net.forward_batch(*chunks[0])
    kept = copy.deepcopy(first)
    later = _run(net, chunks[1:])
    _assert_identical(first, kept)
    assert len(later) == 3


@pytest.mark.parametrize('case', CASES)
def test_finalize_in_any_order_on_any_thread_or_never(cuda_device, monkeypatch, case):
    """Four chunks in flight: the second is never finalized, the fourth is
    finalized on another thread, then the third and the first. Each result
    is the one of the chunk alone, and once all are done or dropped every
    pinned buffer is back with the engine's staging pool."""
    net = _engine(case, cuda_device, monkeypatch)
    chunks = _chunks(case)
    refs = [net.forward_batch(*chunk) for chunk in chunks]
    fins = [net.forward_batch_async(*chunk) for chunk in chunks]
    assert net.staging.lent == 8                  # an input and an output buffer each
    fins[1] = None
    gc.collect()
    results = {}
    thread = threading.Thread(target=lambda: results.__setitem__(3, fins[3]()))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    results[2] = fins[2]()
    results[0] = fins[0]()
    for i in (0, 2, 3):
        _assert_identical(results[i], refs[i])
    assert net.staging.lent == 0
    assert all(buf.is_pinned() for _, buf, _ in net.staging.idle)


@pytest.mark.parametrize('case', CASES)
def test_no_pinned_allocation_after_the_warm_up(cuda_device, monkeypatch, case):
    stats = _host_stats()
    net = _engine(case, cuda_device, monkeypatch)
    chunks = _chunks(case)
    _run(net, chunks * 2)
    before = stats()['num_host_alloc']
    _run(net, chunks * 2)
    assert stats()['num_host_alloc'] == before


def _mc_weights():
    """MonoLoco++ at hidden 1024, 3 stages, people 15 m ahead (theta =
    psi = pi/2), where z = sqrt(d^2 - x^2 - y^2) is well conditioned."""
    params, bn = init_loco_params(0, 34, 9, 1024, 3)
    params['w_fin']['b'][0:3] += torch.tensor([np.pi / 2, np.pi / 2, 15.0])
    return params, bn


@pytest.mark.parametrize('mix', list(mono_grid.MIXES) + ['crowd'])
def test_flat_mc_dispatch_is_the_padded_grid(cuda_device, monkeypatch, mix):
    """The staged flat MC dispatch raises nothing under sync debug mode
    'error', its pinned output holds the flat rows a leaf (`_flat_rows(sum
    L)`, not B x m_bucket, where the grid is larger), and every detection's
    outputs and epi are the padded grid's within F32_RTOL."""
    made = []

    class Recorded(engine._HostCopy):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'float32')
    net = Loco(_mc_weights(), mode='mono', device=cuda_device, n_dropout=10)
    monkeypatch.setattr(engine, '_HostCopy', Recorded)
    kps, kks = (_chunks('mc')[0] if mix == 'crowd'
                else mono_grid.frames(mono_grid.MIXES[mix], seed=len(mix)))
    net.forward_batch(kps, kks)                # builds and warms every kernel
    torch.cuda.synchronize()
    made.clear()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fin = net.forward_batch_async(kps, kks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    outs = fin()
    (out,) = made
    rows = mono_grid.rows([len(k) for k in kps])
    assert {shape[0] for *_, shape in out.leaves} == {rows}
    assert [shape for key, *_, shape in out.leaves if key == 'epi'] == [(rows,)]
    _assert_own_memory(outs)
    mono_grid.assert_close(outs, mono_grid.padded_grid(net, kps, kks), F32_RTOL, F32_RTOL)
