"""The staged copies of `Loco.forward_batch_async` on the CPU.

On every device the engine stages its copies: the padded arrays are views
of one host block, copied to the device in one non-blocking copy, and the
outputs go back, enqueued right after the launches, into one host buffer
(`engine._HostCopy`). Pinned memory and the event need a card
(tests/test_torch_staged_cuda.py); here the same code runs with ordinary
host memory, so its layout and bookkeeping are checked: outputs, keys,
dtypes and shapes included, those of the padded-grid evaluations
(tests/torch_stereo_grid.py, tests/torch_mono_grid.py) up to float order,
for MonStereo, MonoLoco++ with MC dropout and the monoloco_p net; no
blocking copy counted and the row counters kept; aligned views; every leaf
read back in order into memory of its own; the engine's buffers
(`engine._Staging`) lent again only once their copies are done; closures
finalized in any order, on another thread, or never, each giving its
buffers back.
"""

import copy
import gc
import threading

import numpy as np
import pytest
import torch

import torch_mono_grid as mono_grid
import torch_stereo_grid as grid
from monoloco_tpu_torch.models import init_loco_params
from monoloco_tpu_torch.network import Loco, engine
from monoloco_tpu_torch.utils import trace

KINDS = ('stereo', 'mono_mc', 'monoloco_p')
CHUNKS = ('crowd', 'empty_frames', 'unequal', 'no_right_poses')
# f32 throughout; only the order of the sums may differ from the grid's.
RTOL, EPI_RTOL = 1e-5, 1e-4


@pytest.fixture(scope='module')
def engines():
    return {'stereo': Loco(init_loco_params(1, 68, 10, 64, 2), mode='stereo', device='cpu'),
            'mono_mc': Loco(init_loco_params(2, 34, 9, 64, 2), mode='mono', device='cpu',
                            n_dropout=3),
            'monoloco_p': Loco(init_loco_params(3, 34, 9, 64, 2), mode='mono', device='cpu',
                               net='monoloco_p')}


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _chunk(kind, name, seed=0):
    args = (grid.crowd(16, seed=seed) if name == 'crowd'
            else grid.frames(grid.MIXES[name], seed=seed))
    return args if kind == 'stereo' else args[:2]


def _flat(outs):
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


@pytest.mark.parametrize('name', CHUNKS)
@pytest.mark.parametrize('kind', KINDS)
def test_staged_is_the_blocking_path_bit_for_bit(engines, kind, name):
    """The staged outputs are the padded-grid evaluation's, within f32
    tolerance (the grid runs other rows, so its sums may go in another
    order)."""
    net = engines[kind]
    args = _chunk(kind, name, seed=len(name))
    outs = net.forward_batch(*args)
    if kind == 'stereo':
        grid.assert_same(outs, grid.padded_grid(net, *args), exact=False, tol=RTOL)
    else:
        mono_grid.assert_close(outs, mono_grid.padded_grid(net, *args), RTOL, EPI_RTOL)


@pytest.mark.parametrize('kind', KINDS)
def test_staged_counts_no_blocking_copy(engines, kind):
    """The dispatch keeps the span tree and the row counters, and counts 0
    copies that block the host, in and out."""
    args = _chunk(kind, 'unequal')
    trace.enable()
    engines[kind].forward_batch(*args)
    trace.disable()
    counts = {r['name']: r['attrs'] for r in trace.records()}
    left = args[0]
    if kind == 'stereo':
        useful = sum(len(k) * (0 if r is None else len(r)) for k, r in zip(left, args[2]))
        ran = engine._flat_rows(grid.n_pairs(left, args[2]))
    else:
        useful, ran = sum(len(k) for k in left), mono_grid.rows([len(k) for k in left])
    passes = 1 + engines[kind].n_dropout
    assert sorted(counts) == ['loco.bucket', 'loco.d2h', 'loco.dispatch', 'loco.finalize',
                              'loco.h2d', 'loco.launch', 'loco.unpack', 'loco.wait']
    assert counts['loco.dispatch'] == {'rows_useful': useful * passes,
                                       'rows_run': ran * passes, 'h2d_copies': 0}
    assert counts['loco.finalize'] == {'d2h_copies': 0}


def test_layout_aligns_every_array():
    specs = [((3, 5, 3, 17), torch.float32), ((3, 3, 3), torch.float32),
             ((3, 7), torch.bool), ((5,), torch.int64)]
    offsets, size = engine._layout(specs)
    assert all(o % engine._ALIGN == 0 for o in offsets) and size % engine._ALIGN == 0
    block = torch.zeros(size, dtype=torch.uint8)
    views = engine._views(block, specs, offsets)
    ends = [o + v.numel() * v.element_size() for o, v in zip(offsets, views)]
    assert all(e <= o for e, o in zip(ends, offsets[1:] + [size]))
    for v, (shape, dtype) in zip(views, specs):
        assert v.shape == shape and v.dtype == dtype and v.is_contiguous()
        assert v.untyped_storage().data_ptr() == block.untyped_storage().data_ptr()


def test_host_copy_reads_every_leaf_in_order_into_memory_of_its_own():
    """Column slices, the 'yaw' pair, an int64 leaf and epi's (B, m): read
    back in the dict's order, each leaf's shape and dtype, equal bit for bit
    and sharing no memory with the buffer; a second read gives the same."""
    b, m = 3, 4
    raw = torch.randn(b * m, 10)
    dic = {'xyzd': raw[:, 0:4].contiguous(), 'd': raw[:, 3:4], 'ori': raw[:, 7:9],
           'yaw': (raw[:, 5:6], raw[:, 6:7]), 'aux_idx': torch.arange(b * m) % 5,
           'aux': raw[:, 9:10]}
    epi = torch.rand(b, m)
    staging = engine._Staging(pin=False)
    held = [staging.take(100)]
    out = engine._HostCopy(dic, epi, torch.device('cpu'), staging, held)
    assert out.done is None and staging.lent == 2
    buf = out.buf.numpy()
    out.wait()
    host, host_epi = out.read()
    assert list(host) == list(dic) and out.buf is None
    assert staging.lent == 0 and len(staging.idle) == 2
    for key, value in dic.items():
        pairs = zip(host[key], value) if key == 'yaw' else ((host[key], value),)
        for arr, ref in pairs:
            assert arr.dtype == ref.numpy().dtype and arr.shape == tuple(ref.shape), key
            np.testing.assert_array_equal(arr, ref.numpy(), err_msg=key)
            assert not np.shares_memory(arr, buf), key
    np.testing.assert_array_equal(host_epi, epi.numpy())
    assert host_epi.shape == (b, m) and not np.shares_memory(host_epi, buf)
    assert out.read()[0] is host


class _Pending:
    """A copy still running: an event whose query() is false until set."""

    def __init__(self):
        self.finished = False

    def query(self):
        return self.finished


def test_staging_lends_a_buffer_again_only_once_its_copies_are_done():
    staging = engine._Staging(pin=False)
    staging.cap = 3
    a = staging.take(1000)
    assert a.numel() == 1024 and a.dtype == torch.uint8 and staging.lent == 1
    pending = _Pending()
    staging.give([a], pending)
    assert staging.lent == 0
    b = staging.take(1000)                   # a's copy still runs: a new buffer
    assert b.data_ptr() != a.data_ptr()
    pending.finished = True
    assert staging.take(600).data_ptr() == a.data_ptr()      # 600 rounds to 1024
    small, big = staging.take(10), staging.take(5000)
    assert staging.lent == 4 and big.numel() == 8192
    staging.give([b, small, big], None)
    assert [n for n, _, _ in staging.idle] == [16, 1024, 8192]
    assert staging.take(12).data_ptr() == small.data_ptr()   # the smallest that fits
    staging.give([a, small], None)
    assert [n for n, _, _ in staging.idle] == [1024, 1024, 8192]   # the cap turns one away
    assert staging.lent == 0


def test_results_hold_their_memory_and_give_it_back_when_dropped():
    """Each chunk's results are views of one leased slab of ordinary memory:
    while any of them lives no later chunk gets that slab, and once the last
    is gone the next chunk reuses it."""
    staging = engine._Staging(pin=False)
    lease = staging.lease(1000)
    arr = np.asarray(lease)
    assert arr.size == 1024 and staging.slabs == []
    part = arr[8:16].view(np.float32)
    del lease, arr
    other = np.asarray(staging.lease(1000))
    assert not np.shares_memory(other, part)        # part still holds its slab
    ptr = part.__array_interface__['data'][0] - 8
    del part
    assert [a.__array_interface__['data'][0] for a in staging.slabs] == [ptr]
    assert np.asarray(staging.lease(900)).__array_interface__['data'][0] == ptr


@pytest.mark.parametrize('kind', KINDS)
def test_closures_finalize_in_any_order_on_any_thread_or_never(engines, kind):
    net = engines[kind]
    chunks = [_chunk(kind, 'crowd', seed=s) for s in range(4)]
    refs = [net.forward_batch(*args) for args in chunks]
    fins = [net.forward_batch_async(*args) for args in chunks]
    fins[1] = None
    gc.collect()
    results = {}
    thread = threading.Thread(target=lambda: results.__setitem__(3, fins[3]()))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    results[2] = fins[2]()
    results[0] = fins[0]()
    kept = copy.deepcopy(results[0])
    later = [net.forward_batch(*args) for args in chunks[1:]]
    for i in (0, 2, 3):
        _assert_identical(results[i], refs[i])
    _assert_identical(results[0], kept)
    _assert_identical(later[0], refs[1])
    assert net.staging.lent == 0
