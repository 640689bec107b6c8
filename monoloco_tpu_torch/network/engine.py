"""Inference engine: the `Loco` of `monoloco_tpu/network/engine.py` in torch,
mono (MonoLoco++) and stereo (MonStereo).

Per dispatch, on the engine's device: K^-1 keypoint normalization (for
stereo, the all-vs-all pairing of left and right poses), the BN-folded
residual MLP, for stereo the choice of each left pose's right partner by the
aux logit, and the physical decode. Everything after (ground truth matching,
output dict assembly, the activity rules) is host numpy on a handful of
detections. `forward` (one image) and `forward_batch_async` (many) run the
same dispatch (`Loco._dispatch`).

MLP routing (`_mlp_forward`), as in the JAX package off the TPU:
 - default / float32: the plain f32 folded forward (`FoldedLoco`, torch.matmul);
 - int8: the fused dynamic-int8 kernel (ops/fused_mlp.py) for dispatches of
   at least `_INT8_MIN_ROWS` MLP rows, the f32 path below that;
 - bfloat16: the K1-bf16 kernel (`fused_loco_forward` on a bf16 pack made
   once at init) for every dispatch of a Loco net with hidden % 128 == 0;
   the legacy nets and other widths run `folded_forward` on bf16-rounded
   operands (exact products, f32 sums), the same function without a kernel;
 - tensorfloat32: the f32 folded forward with TF32 on around the MLP only.
K^-1 and decode stay f32 under every precision.
`_INT8_MIN_ROWS = 16` is the crossover measured on an NVIDIA H100 80GB HBM3
at a 700 W power limit by `monoloco_tpu_torch/tools/bench_int8_crossover.py`
(the whole serving program, dyn8 against the f32 path it replaces, 16 to
131072 rows): in two runs dyn8 won at every measured row count, the
smallest being 16 (1.04-1.26x up to 2048 rows, where both are bound by the
host's launches; 1.95-2.40x at 8192, 7.1x at 131072). The JAX package's 512 was a TPU v5e's
dyn8/bf16 crossover.

Detection counts pad to power-of-two buckets (`_bucket`): the JAX package
needs them to bound recompiles, and the port's host arrays keep its layout.
Stereo pads m and r to their buckets separately, but the MLP runs only each
image's real L x R pairs, packed end to end and rounded up to the kernels'
128-row tile (`_flat_rows`, at least one tile); routing reads that row
count, so at the default floor every stereo dispatch runs dyn8 under int8,
as with the padded grid (at least 4 x 4). The aux argmax runs
over each image's (m, r) grid with the padded cells at -inf. Mono runs
likewise one row a real detection, image by image, rounded up to the tile
(`_mono_flat`), but never more rows than its padded (B, m) grid
(`_mono_rows`): a small dispatch, one image of up to 256 detections
included, runs, and routes, as many rows as its bucket.

MC-dropout epistemic uncertainty (`n_dropout > 0`, mono nets; stereo keeps
epi at zeros, as in the JAX package) is one more dispatch after the main
one: the n_dropout passes stacked on a leading axis through
`folded_forward_mc` (the folded f32 net on the device, TF32 off, under every
precision), 100 Laplace samples a pass and the std over all of them. The
keep-masks and the uniforms come from torch.Generators on the device made
afresh on every dispatch (seed 0 and 1) over the detection bucket: the same
for every pass's uniforms and, in a batch, for every image, as the JAX
package's fixed keys and its vmap over images make them; each row takes
the draws of its place in its image (`mc_rows`).
`forward`, `forward_batch` and `forward_batch_async` also take them
injected (`mc=(masks, u)`), and `mc_last` keeps the last ones drawn.

Under a mesh (`mesh=`, a `parallel.Mesh`; every rank builds the same Loco
and calls `forward_batch_async` with the same images), the image bucket
pads to a multiple of the data ranks, each rank runs its share of the
images through the same routing (so dyn8 from 16 MLP rows a rank, and
K1-bf16 under bf16), and the outputs are all-gathered over the data group:
every rank gets what one device computes; mono runs every cell of the
rank's share of the padded (B, m) grid there, since the gather takes equal
pieces. The dispatch counters count the rows of a rank's share, as the JAX
engine's `_dispatch_shard_factor`. A mesh with a model axis above 1
computes the data shards alike on the ranks of a model group, with the full
weights; it warns and drops the int8 route, as the JAX engine does (its
Pallas kernel has no partitioning rule over the model axis). `forward`,
one image, computes locally on every rank and makes no collective.
"""

import bisect
import functools
import math
import os
import threading
import warnings
from collections import defaultdict

import numpy as np
import torch

from ..activity import is_raising_hand, social_interactions
from ..geometry import get_iou_matches, reorder_matches
from ..geometry.host import np_get_keypoints, np_pixel_to_camera, np_xyz_from_distance
from ..geometry.stereo import BF, mask_joint_disparity
from ..models import (FoldedLoco, dropout_masks, fold_eval_params, folded_forward,
                      folded_forward_mc, load_checkpoint, n_dropout_sites, params_from_numpy,
                      round_bf16)
from ..parallel import gather_rows, row_range
from ..ops import (fused_loco_forward, fused_loco_forward_dyn8_auto, pack_folded_weights,
                   pack_folded_weights_w8)
from ..utils import trace
from ..utils.precision import serve_storage, serving_precision, tf32_matmuls
from .decode import (extract_outputs, extract_outputs_mono, laplace_sampling,
                     laplace_uniforms, unnormalize_bi)
from .preprocess import preprocess_monoloco
# Importable from here, as from the JAX engine.
from .preprocess import preprocess_monstereo  # noqa: F401
# The unfolded forwards, importable from here as from the JAX engine, which
# runs its MC-dropout passes on them (the port runs those on the folded net).
from ..models import loco_forward, monoloco_forward  # noqa: F401

N_SAMPLES = 100
# The legacy MonoLoco net's width, the JAX engine's `linear_size` for
# net='monoloco_p'; there as here the checkpoint's shape decides.
LINEAR_SIZE_MONO = 256
# The measured dyn8-vs-f32 crossover on the H100 (module docstring).
_INT8_MIN_ROWS = 16
# The row tile of the MLP kernels (`kBM` in ops/csrc/wgmma_layer.cu).
_ROW_TILE = 128


def _int8_routes(weights, n_rows):
    """Whether an n_rows dispatch runs the dyn8 kernel. Shared by
    `_mlp_forward` and the dispatch counters, so the two never disagree."""
    return (isinstance(weights, dict)
            and weights.get('packed_int8') is not None
            and n_rows >= _INT8_MIN_ROWS)


def _mlp_forward(weights, inputs, arch):
    """Eval MLP. `weights` is Loco's {'folded': FoldedLoco, 'packed_int8':
    dyn8 weights or None, 'packed_bf16': K1-bf16 weights or None,
    'precision': the canonical precision}, or a bare folded dict from direct
    callers (plain f32)."""
    if not (isinstance(weights, dict) and 'folded' in weights):
        return folded_forward(weights, inputs, arch=arch)
    if _int8_routes(weights, inputs.shape[0]):
        return fused_loco_forward_dyn8_auto(weights['packed_int8'], inputs)
    if weights.get('packed_bf16') is not None:
        return fused_loco_forward(None, inputs, packed=weights['packed_bf16'])
    precision = weights.get('precision')
    if precision == 'bfloat16':
        return folded_forward(weights['folded'].folded(), inputs, arch=arch,
                              operand=round_bf16)
    if precision == 'tensorfloat32':
        with tf32_matmuls():
            return weights['folded'](inputs)
    return weights['folded'](inputs)


def _bucket(n, minimum=4):
    b = minimum
    while b < n:
        b *= 2
    return b


def _flat_rows(n_pairs):
    """The MLP rows of a flat dispatch of n_pairs real rows (stereo pairs,
    mono detections): rounded up to the kernels' row tile, at least one
    tile."""
    return max(_ROW_TILE, -(-n_pairs // _ROW_TILE) * _ROW_TILE)


def _mono_rows(counts, b_bucket, m_bucket):
    """The MLP rows of a flat mono dispatch of images with `counts`
    detections: the real ones rounded up to the row tile, but no more than
    the padded (B m) grid, so that a small dispatch runs, and routes
    (`_INT8_MIN_ROWS`), as many rows as its bucket."""
    return min(b_bucket * m_bucket, _flat_rows(sum(counts)))


def _mono_cells(counts, m_bucket):
    """Each real detection's cell in the padded (B m) grid, image by image:
    the first sum(counts) flat rows of a mono dispatch."""
    counts = np.asarray(counts, np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(counts.sum()) + np.repeat(np.arange(counts.size) * m_bucket - starts,
                                               counts)


# Arrays laid out in one staging block start on multiples of this, the
# caching device allocator's alignment, so a view of the block on the device
# is aligned as a fresh tensor is and every kernel takes the same path.
_ALIGN = 512


def _layout(specs):
    """Byte offsets of arrays `specs` ((shape, torch dtype) each) laid end to
    end in one block, each at a multiple of `_ALIGN`, and the block's size."""
    offsets, size = [], 0
    for shape, dtype in specs:
        offsets.append(size)
        size += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return offsets, size


@functools.cache
def _numpy_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _views(block, specs, offsets):
    """The arrays `specs` as views of the uint8 `block` at `offsets`: tensors
    of a tensor, numpy arrays of a numpy array (no torch op, so none for the
    profiler to record on the host's path)."""
    views = []
    for (shape, dtype), o in zip(specs, offsets):
        part = block[o:o + math.prod(shape) * dtype.itemsize]
        views.append(part.view(_numpy_dtype(dtype) if isinstance(part, np.ndarray) else dtype)
                     .reshape(shape))
    return views


def _pow2(size):
    return 1 << max(size - 1, 1).bit_length()


class _Staging:
    """The host memory of one engine's dispatches, reused from chunk
    to chunk. Buffers: uint8 tensors from PyTorch's caching host allocator
    (pinned on a card), each lent to one dispatch and given back, with the
    event after its last copy, when the dispatch's finalize has read it or
    its closure is dropped; one is lent again only once that event has
    completed, so the device never reads or writes a buffer the host
    refills. Slabs: ordinary numpy memory under one chunk's results
    (`_Lease`), back once the last result array is gone. So a steady loop
    allocates nothing new, pinned or not (d chunks in flight, finalized in
    order, hold d chunks' buffers), and the host does not fault fresh pages
    in on every chunk. Sizes round up to a power of two, so chunks of similar
    buckets share them; at most `cap` buffers and `cap` slabs wait for
    reuse, the smallest first. A reentrant lock guards both: closures may be
    finalized, and results dropped, on any thread, and a collection run
    inside a locked section may give back what it frees."""

    cap = 8

    def __init__(self, pin):
        self.pin = pin
        self.idle = []           # (size, buffer, event or None), by size
        self.slabs = []          # numpy uint8 arrays, by size
        self.lent = 0
        self._lock = threading.RLock()

    def take(self, size):
        with self._lock:
            self.lent += 1
            for i, (n, buf, done) in enumerate(self.idle):
                if n >= size and (done is None or done.query()):
                    del self.idle[i]
                    return buf
        return torch.empty(_pow2(size), dtype=torch.uint8, pin_memory=self.pin)

    def give(self, bufs, done):
        with self._lock:
            self.lent -= len(bufs)
            for buf in bufs:
                if len(self.idle) < self.cap:
                    bisect.insort(self.idle, (buf.numel(), buf, done), key=lambda e: e[0])

    def lease(self, size):
        """Ordinary host memory of at least `size` bytes (a `_Lease`)."""
        with self._lock:
            for i, slab in enumerate(self.slabs):
                if slab.size >= size:
                    return _Lease(self, self.slabs.pop(i))
        return _Lease(self, np.empty(_pow2(size), np.uint8))

    def restore(self, slab):
        with self._lock:
            if len(self.slabs) < self.cap:
                bisect.insort(self.slabs, slab, key=lambda a: a.size)


class _Lease:
    """A slab of ordinary host memory under one chunk's results. Every array
    made from it (`np.asarray`, then views) keeps it alive; when the last is
    gone the slab goes back to its `_Staging`. So results own their memory,
    and no later chunk writes into it while one of them lives."""

    def __init__(self, staging, slab):
        self.staging, self.slab = staging, slab

    @property
    def __array_interface__(self):
        return self.slab.__array_interface__

    def __del__(self):
        self.staging.restore(self.slab)


class _HostCopy:
    """A dispatch's outputs on their way to the host, enqueued right after its
    launches. The leaves (each tensor of the output dict, 'yaw' as two, and
    the MC 'epi') of a dtype go flat, each in its own row-major order, end to
    end in one device block; each block is copied without blocking into one
    host buffer from `staging` behind an event. `held` are the dispatch's
    other staging buffers (its input block), given back with this one.
    `wait()` syncs the event; `read()` copies the buffer in one piece into
    ordinary memory leased from `staging`, so that no result aliases it,
    gives the buffers back, and returns each leaf as a view of that copy in
    the leaf's shape and dtype. Dropped unread, it gives them back with the
    event pending."""

    def __init__(self, dic, epi, device, staging, held):
        leaves = [(k, j, t) for k, v in dic.items()
                  for j, t in (enumerate(v) if k == 'yaw' else ((None, v),))]
        if epi is not None:
            leaves.append(('epi', None, epi))
        groups, self.leaves = {}, []
        for key, j, t in leaves:
            parts = groups.setdefault(t.dtype, [])
            e0 = sum(p.numel() for p in parts)
            self.leaves.append((key, j, list(groups).index(t.dtype), e0, e0 + t.numel(),
                                tuple(t.shape)))
            parts.append(t.reshape(-1))
        blocks = [torch.cat(parts) if len(parts) > 1 else parts[0] for parts in groups.values()]
        self.specs = [(tuple(b.shape), b.dtype) for b in blocks]
        self.offsets, self.size = _layout(self.specs)
        self.buf = staging.take(self.size)
        for view, block in zip(_views(self.buf, self.specs, self.offsets), blocks):
            view.copy_(block, non_blocking=True)
        self.done = None
        if device.type == 'cuda':
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(device))
        self.staging, self.held, self.host = staging, held + [self.buf], None

    def wait(self):
        if self.done is not None:
            self.done.synchronize()

    def read(self):
        """(the output dict, epi or None) in ordinary numpy arrays."""
        if self.host is None:
            raw = np.asarray(self.staging.lease(self.size))[:self.size]
            np.copyto(raw, self.buf.numpy()[:self.size])
            flat = _views(raw, self.specs, self.offsets)
            dic, epi = {}, None
            for key, j, g, e0, e1, shape in self.leaves:
                arr = flat[g][e0:e1].reshape(shape)
                if key == 'epi':
                    epi = arr
                elif j is None:
                    dic[key] = arr
                else:
                    dic[key] = dic.get(key, ()) + (arr,)
            self.host = dic, epi
            self._give_back()
        return self.host

    def _give_back(self):
        if getattr(self, 'held', None) is not None:
            self.staging.give(self.held, self.done)
            self.held = self.buf = None

    def __del__(self):
        self._give_back()


def default_device():
    """The card. Without one this raises: the CPU runs only when asked for
    (`device='cpu'`, `predict --disable-cuda`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found: pass device='cpu' (predict: --disable-cuda) "
                           "to run on the CPU")
    return torch.device('cuda')


class Loco:
    """Load a localization net and run preprocess -> forward -> postprocess.

    `model` is a checkpoint path (a native pickle, an orbax directory whose
    name ends in `.orbax`, or a reference torch state_dict, read by
    `models.load_checkpoint`) or a (params, bn_state) tuple."""

    NETS = ('monstereo', 'monoloco_pp', 'monoloco_p', 'monoloco')

    def __init__(self, model, mode='mono', net=None, device=None, n_dropout=0,
                 p_dropout=0.2, linear_size=1024, n_stage=3, mesh=None):
        if mode not in ('mono', 'stereo'):
            raise ValueError(f"mode not recognized: {mode}")
        self.mode = mode
        self.mesh = mesh
        if net is None:
            net = 'monoloco_pp' if mode == 'mono' else 'monstereo'
        if net not in self.NETS:
            raise ValueError(f"net not recognized: {net}")
        self.net = net
        self.arch = 'monoloco' if self.net in ('monoloco', 'monoloco_p') else 'loco'
        self.n_dropout = n_dropout
        self.p_dropout = p_dropout
        self.mc_last = None
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device) if device is not None else default_device()

        if isinstance(model, (str, os.PathLike)):
            self.params, self.bn_state, _ = load_checkpoint(model, device=self.device)
        elif isinstance(model, tuple):
            self.params, self.bn_state = params_from_numpy(*model, device=self.device)
        else:
            raise TypeError("model must be a checkpoint path or a (params, bn_state) tuple")
        # linear_size and n_stage are hints, as in the JAX package: the
        # checkpoint is the source of truth for the architecture size.
        self.linear_size = int(self.params['w1']['w'].shape[1])
        self.n_stage = int(self.params['stages']['w1']['w'].shape[0])
        self.folded = fold_eval_params(self.params, self.bn_state, arch=self.arch)
        self.precision = serving_precision()
        # The spelling as given (serve's /healthz reports it, as the JAX
        # server reports its `utils.precision._RAW`).
        self.precision_raw = os.environ.get('MONOLOCO_TPU_PRECISION', 'default')
        # Weights are stored f32 (the JAX package casts to bf16 only on a
        # TPU); under int8 the dyn8 weights and under bfloat16 the K1-bf16
        # weights are packed once, here, for mono and the stereo pairing
        # alike. MC dropout runs the f32 `FoldedLoco` under every precision.
        self.serve_storage = serve_storage()
        self.mlp_weights = {'folded': FoldedLoco(self.folded, self.arch).to(self.device),
                            'packed_int8': None, 'packed_bf16': None,
                            'precision': self.precision}
        kernel_width = self.arch == 'loco' and self.linear_size % 128 == 0
        if self.precision == 'int8' and kernel_width:
            if mesh is not None and mesh.tp > 1:
                warnings.warn(
                    "MONOLOCO_TPU_PRECISION=int8 is ignored under a device mesh with a model "
                    "axis: the int8 route serves data shards only. Serving the float32 path "
                    "instead.", RuntimeWarning)
            else:
                self.mlp_weights['packed_int8'] = pack_folded_weights_w8(self.folded)
        if self.precision == 'bfloat16' and kernel_width:
            self.mlp_weights['packed_bf16'] = pack_folded_weights(self.folded, torch.bfloat16)
        # Which MLP path each dispatch ran: the int8 kernel only engages at
        # >= _INT8_MIN_ROWS MLP rows. One count a call of `forward` or
        # `forward_batch_async`, its MC dispatch included, as the JAX engine
        # counts them; serve's /healthz and /metrics export both.
        self.n_dispatches = 0
        self.n_dispatches_int8 = 0
        # The host memory of the dispatch's copies, one block in and one
        # out, neither blocking the host (pinned on a card).
        self.staging = _Staging(pin=self.device.type == 'cuda')

    def _count_dispatch(self, n_rows):
        self.n_dispatches += 1
        if _int8_routes(self.mlp_weights, n_rows):
            self.n_dispatches_int8 += 1

    def _decode_mono(self, raw):
        if self.net == 'monoloco':
            return {'d': raw[:, 0:1], 'bi': unnormalize_bi(raw)}
        return extract_outputs_mono(raw) if self.net == 'monoloco_p' else extract_outputs(raw)

    def _mono_flat(self, kps, kk, cells, mc=None):
        """An image batch on the device: kps (B, m, 3, 17), kk (B, 3, 3) and
        cells (rows,) int32, each flat row's cell in the (B m) grid: the real
        detections image by image (`_mono_cells`), then cell 0; under a mesh
        every cell of the rank's images ->
        (the decoded output dict over the rows, and with MC dropout their
        epistemic std (rows,), else None). The MLP and the MC passes run
        the gathered rows only; a padded cell's output is never used. The
        legacy 'monoloco' net takes zero-centred inputs and decodes to
        {'d', 'bi'}."""
        x = preprocess_monoloco(kps, kk, zero_center=self.net == 'monoloco')
        x = x.reshape(-1, x.shape[-1]).index_select(0, cells)
        dic = self._decode_mono(_mlp_forward(self.mlp_weights, x, self.arch))
        if not self._mc_on():
            return dic, None
        m = kps.shape[1]
        return dic, self.mc_rows(x, cells % m, m, mc)

    def _stereo_forward(self, kps_l, kps_r, poses, kk, n_pairs):
        """An image batch on the device: left (B, m, 3, 17), right (B, r, 3,
        17), poses (B, m + r) bool (which left, then which right poses are
        real), kk (B, 3, 3), and n_pairs, the sum over the images of their
        real left x right pairs -> (the decoded output dict over the B*m left
        poses, each with its chosen pairing, and the (B, m) index of the
        right pose chosen). One MLP call over the real pairs only, packed
        image by image in (left, right) order, each row [inp_l_i, inp_l_i -
        inp_r_j] as `preprocess_monstereo` makes it; the rows up to
        `_flat_rows(n_pairs)` are zeros, and no output of theirs is used.
        The JAX package vmaps its padded m x r program over the images."""
        b, m, r = kps_l.shape[0], kps_l.shape[1], kps_r.shape[1]
        inp_l = preprocess_monoloco(kps_l, kk).reshape(b * m, -1)
        inp_r = preprocess_monoloco(kps_r, kk).reshape(b * r, -1)
        valid = (poses[:, :m, None] & poses[:, None, m:]).reshape(-1)   # (B m r)
        ends = torch.cumsum(valid, 0)
        # Flat row p holds the grid cell of the (p + 1)-th real pair; the
        # rows after the last one point past the grid and are zeroed below.
        cell = torch.searchsorted(ends, torch.arange(_flat_rows(n_pairs), device=ends.device),
                                  right=True).clamp_(max=b * m * r - 1)
        left = cell // r
        right = left // m * r + cell % r
        x_l = inp_l[left]
        inputs = torch.cat([x_l, x_l - inp_r[right]], dim=1)
        inputs[n_pairs:] = 0
        raw = _mlp_forward(self.mlp_weights, inputs, 'loco')
        # Each grid cell's flat row (a padded cell's is any real row's, and
        # its aux is -inf, so it never wins); the first maximum wins a tie,
        # as in jnp.argmax.
        row = (ends - 1).clamp_(min=0)
        aux = torch.where(valid, raw[row, -1], -math.inf).reshape(b, m, r)
        best = torch.argmax(aux, dim=2)                              # (B, m)
        chosen = torch.take_along_dim(row.reshape(b, m, r), best[:, :, None], dim=2)
        return extract_outputs(raw[chosen.reshape(-1)]), best

    def draw_mc(self, rows):
        """(masks, u) for one MC dispatch over images of `rows` padded
        detections: `n_dropout_sites` keep-masks (n_dropout, rows, hidden)
        bool and the Laplace uniforms (N_SAMPLES, rows), on the device, from
        generators seeded 0 and 1 afresh on every call."""
        masks = dropout_masks(self.n_dropout, rows, self.linear_size,
                              n_dropout_sites(self.n_stage, self.arch), self.p_dropout,
                              self.device, seed=0)
        return masks, laplace_uniforms(N_SAMPLES, rows, self.device, seed=1)

    def mc_rows(self, x, pos, m, mc=None):
        """The epistemic std of rows in one dispatch: x (rows, in), the MLP's
        inputs, and pos (rows,) int, each row's place in its image, below m
        -> (rows,) f32. The draws are those of images padded to m detections
        (`draw_mc(m)`, or `mc` injected; kept in `mc_last`), alike for every
        image, and each row takes the keep-mask rows and uniforms of its
        place. The n_dropout passes run stacked, (n_dropout, rows, H); each
        pass's distance mean and Laplace spread (columns 0:2 of the legacy
        'monoloco' net, 2:4 otherwise) give N_SAMPLES samples, and the std
        (ddof 1) is over all n_dropout * N_SAMPLES of a row's."""
        masks, u = self.draw_mc(m) if mc is None else mc
        self.mc_last = (masks, u)
        # One gather for every site: each launch costs the host.
        keep = torch.stack(masks).index_select(2, pos).unbind()
        out = folded_forward_mc(self.mlp_weights['folded'].folded(), x, keep,
                                self.p_dropout, self.arch)                   # (n, rows, out)
        db = out[..., 0:2] if self.net == 'monoloco' else out[..., 2:4]
        mu_b = torch.cat([db[..., 0:1], unnormalize_bi(db)], dim=-1)
        samples = laplace_sampling(mu_b, N_SAMPLES, u=u.index_select(1, pos))  # (n, S, rows)
        return torch.std(samples.reshape(-1, x.shape[0]), dim=0, correction=1)

    def _mc_on(self):
        return self.n_dropout > 0 and self.net != 'monstereo'

    def forward(self, keypoints, kk, keypoints_r=None, mc=None):
        """One image: keypoints (m, 3, 17), kk (3, 3), and for the stereo net
        the right image's keypoints (r, 3, 17) (None or empty: the first left
        pose stands in) -> dict of numpy arrays (m rows each; 'yaw' is a
        (pred, egocentric) pair; stereo adds 'aux' and 'aux_idx', the right
        pose chosen per left pose). 'epi' is the MC-dropout std with
        n_dropout > 0 on a mono net (`mc`: injected draws for `mc_rows`,
        over the padded bucket), else zeros. A batch of one, computed on
        this rank alone under a mesh: it makes no collective."""
        if keypoints is None or len(keypoints) == 0:
            return None
        return self._dispatch([keypoints], [kk], [keypoints_r], mc, None)()[0]

    def forward_batch(self, keypoints_list, kk_list, keypoints_r_list=None, mc=None):
        """Run many images in one dispatch (see forward_batch_async)."""
        return self.forward_batch_async(keypoints_list, kk_list, keypoints_r_list, mc)()

    def forward_batch_async(self, keypoints_list, kk_list, keypoints_r_list=None, mc=None):
        """Launch one dispatch over many images; returns a zero-arg finalize()
        producing the per-image output dicts (None for an image without
        detections), identical in layout to `forward`'s.
        With n_dropout > 0 on a mono net a second dispatch computes 'epi'
        for the whole batch (`mc`: injected draws over the shared detection
        bucket, see `mc_rows`).

        keypoints_r_list (stereo net): per-image right keypoints (r_i, 3, 17);
        an entry may be None or empty, and then the image's first left pose
        stands in, as in `forward`.

        CUDA launches are asynchronous, so the caller can prepare the next
        chunk or write files before finalize() waits for this one. Images pad
        to shared detection buckets, as in the JAX package; the MLP and the
        MC passes run one flat row a real detection (mono, `_mono_flat`, at
        most the padded grid's rows; under a mesh the rank's share of that
        grid) or a real pair (stereo), rounded up to the row tile.

        Nothing here blocks the host on the device. The padded arrays are
        numpy views of one zeroed host block (pinned on a card), copied to
        the device in one copy without blocking; under a mesh each rank
        copies the whole block and slices its images on the device. The
        outputs (gathered under a mesh) are enqueued for the host right
        after the launches, into one host buffer behind an event of this
        dispatch's own (`_HostCopy`). So finalize() waits for this chunk's
        work and copies only, never for a chunk dispatched after it.
        Closures may be finalized in any order, on any thread, or dropped:
        either gives the two buffers back to the engine's pool (`_Staging`),
        which lends them again once their copies are done, so a steady loop
        allocates no new host memory. Results own their memory: no returned
        array aliases a buffer that a later dispatch reuses.

        With tracing on (`utils/trace.py`) the call is a `loco.dispatch` span
        holding `loco.bucket` (the buckets and the padded host arrays),
        `loco.h2d` (the one enqueued copy of the block to the device) and
        `loco.launch` (the forward, the gather and the MC passes, and the
        outputs' copies to the host, all enqueued); its counters are
        `rows_useful` (sum L, or L x R, a frame), `rows_run` (the rows the
        MLP runs: the flat pairs rounded up to the row tile; mono the flat
        detections so rounded, at most the padded bucket B m, and under a
        mesh that bucket of a rank), both x (1 + n_dropout) with MC, and
        `h2d_copies`. finalize() is a `loco.finalize` span of the same
        dispatch id, counting `d2h_copies`, holding `loco.wait` (a sync on
        the event after this dispatch's copies to the host), `loco.d2h` (the
        copy out of the host buffer into ordinary arrays) and `loco.unpack`
        (the per-image slicing). `h2d_copies` and `d2h_copies` count the
        copies that block the host on the device: 0 and 0.
        """
        return self._dispatch(keypoints_list, kk_list, keypoints_r_list, mc, self.mesh)

    def _dispatch(self, keypoints_list, kk_list, keypoints_r_list, mc, mesh):
        """`forward_batch_async` over `mesh` (None: this rank alone)."""
        n_img = len(keypoints_list)
        if n_img == 0:
            return lambda: []
        stereo = self.net == 'monstereo'
        with trace.span('loco.dispatch') as root:
            with trace.span('loco.bucket'):
                counts = [0 if k is None else len(k) for k in keypoints_list]
                m_bucket = _bucket(max(max(counts), 1))
                b_bucket = _bucket(n_img, minimum=1)
                dp = 1 if mesh is None else mesh.dp
                if dp > 1:
                    # The image axis splits over the data ranks: pad the batch
                    # bucket up to a multiple of them.
                    b_bucket = max(b_bucket, dp)
                    b_bucket += (-b_bucket) % dp
                lo, hi = (0, b_bucket) if dp == 1 else row_range(b_bucket, mesh)
                specs = [((b_bucket, m_bucket, 3, 17), torch.float32),
                         ((b_bucket, 3, 3), torch.float32)]
                if stereo:
                    if keypoints_r_list is None:
                        keypoints_r_list = [None] * n_img
                    counts_r = [0 if k is None else len(k) for k in keypoints_r_list]
                    r_bucket = _bucket(max(max(counts_r), 1))
                    specs += [((b_bucket, r_bucket, 3, 17), torch.float32),
                              ((b_bucket, m_bucket + r_bucket), torch.bool)]
                else:
                    # Under a mesh the rank's share of the padded grid: the
                    # gather takes equal pieces from every rank.
                    rows = ((hi - lo) * m_bucket if mesh is not None
                            else _mono_rows(counts, b_bucket, m_bucket))
                    specs.append(((rows,), torch.int32))
                # One zeroed host block (pinned on a card) holds every array;
                # the arrays are numpy views of it.
                offsets, size = _layout(specs)
                block = self.staging.take(size)
                raw = block.numpy()[:size]
                raw.fill(0)
                host = _views(raw, specs, offsets)
                kps, kks = host[0], host[1]
                kks[:] = np.eye(3)
                for i, (k, kk) in enumerate(zip(keypoints_list, kk_list)):
                    if counts[i]:
                        kps[i, :counts[i]] = np.asarray(k, np.float32)
                    kks[i] = np.asarray(kk, np.float32)
                # Each image's first output row.
                starts = range(0, n_img * m_bucket, m_bucket)
                if stereo:
                    # Which poses are real: an image's left ones, then its right.
                    kps_r, poses = host[2], host[3]
                    for i in range(n_img):
                        poses[i, :counts[i]] = True
                        if counts_r[i]:
                            kps_r[i, :counts_r[i]] = np.asarray(keypoints_r_list[i],
                                                                np.float32)
                            poses[i, m_bucket:m_bucket + counts_r[i]] = True
                        elif counts[i]:
                            # No right detections: the first left pose stands in.
                            kps_r[i, 0] = kps[i, 0]
                            poses[i, m_bucket] = True
                elif mesh is not None:
                    host[2][:] = np.arange(rows)
                else:
                    # Each flat row's cell in the (B m) grid; the rows after
                    # the last detection keep cell 0.
                    cells = _mono_cells(counts, m_bucket)
                    host[2][:cells.size] = cells
                    starts = np.cumsum(counts) - counts

            mine = range(lo, min(hi, n_img))
            if stereo:
                n_pairs = sum(counts[i] * max(counts_r[i], 1) for i in mine)
                rows = _flat_rows(n_pairs)
            with torch.inference_mode():
                self._count_dispatch(rows)
                with trace.span('loco.h2d'):
                    on_dev = _views(block[:size].to(self.device, non_blocking=True),
                                    specs, offsets)
                    if mesh is not None:
                        # This rank's images of each per-image array.
                        n = len(on_dev) if stereo else 2
                        on_dev = [a[lo:hi] for a in on_dev[:n]] + on_dev[n:]
                with trace.span('loco.launch'):
                    if stereo:
                        kps_dev, kks_dev, kps_r_dev, poses_dev = on_dev
                        dic, best = self._stereo_forward(kps_dev, kps_r_dev, poses_dev,
                                                         kks_dev, n_pairs)
                        dic['aux_idx'] = best.reshape(-1)
                        epi = None
                    else:
                        dic, epi = self._mono_flat(*on_dev, mc)
                    if mesh is not None:
                        dic = {k: (tuple(gather_rows(t, mesh) for t in v) if k == 'yaw'
                                   else gather_rows(v, mesh)) for k, v in dic.items()}
                        if epi is not None:
                            epi = gather_rows(epi, mesh)
                    out = _HostCopy(dic, epi, self.device, self.staging, [block])
            if root:
                passes = 1 + self.n_dropout if self._mc_on() else 1
                useful = (sum(counts[i] * counts_r[i] for i in mine) if stereo
                          else sum(counts[i] for i in mine))
                root.set(rows_useful=useful * passes, rows_run=rows * passes, h2d_copies=0)

        def finalize():
            with trace.span('loco.finalize', dispatch=root.dispatch) as fin:
                with trace.span('loco.wait'):
                    out.wait()
                with trace.span('loco.d2h'):
                    dic, epi = out.read()
                with trace.span('loco.unpack'):
                    outs = []
                    for i, m in enumerate(counts):
                        if m == 0:
                            outs.append(None)
                            continue
                        sl = slice(starts[i], starts[i] + m)
                        dic_i = {k: (v[0][sl], v[1][sl]) if k == 'yaw' else v[sl]
                                 for k, v in dic.items()}
                        dic_i['epi'] = [0.] * m if epi is None else epi[sl]
                        outs.append(dic_i)
                if fin:
                    fin.set(d2h_copies=0)
            return outs

        return finalize

    @staticmethod
    def post_process(dic_in, boxes, keypoints, kk, dic_gt=None, iou_min=0.3,
                     reorder=True, verbose=False):
        """Assemble the final per-image output dict (the reference's key set
        and confidence formula conf = 0.035*box_conf/(bi/distance)). A copy of
        the JAX package's host code, defaultdict quirks included."""
        dic_out = defaultdict(list)
        if dic_in is None:
            return dic_out

        if dic_gt:
            boxes_gt = dic_gt['boxes']
            dds_gt = [el[3] for el in dic_gt['ys']]
            matches = get_iou_matches(boxes, boxes_gt, iou_min=iou_min)
            if verbose:
                print(f"found {len(matches)} matches with ground-truth")
            idxs_matches = [el[0] for el in matches]
            not_matches = [idx for idx, _ in enumerate(boxes) if idx not in idxs_matches]
        else:
            matches = []
            not_matches = list(range(len(boxes)))
            if verbose:
                print("NO ground-truth associated")

        if reorder and matches:
            matches = reorder_matches(matches, boxes, mode='left_right')

        all_idxs = [idx for idx, _ in matches] + not_matches
        dic_out['gt'] = [True] * len(matches) + [False] * len(not_matches)
        # Original annotation index of each output row.
        dic_out['indices'] = [int(i) for i in all_idxs]

        kps_np = np.asarray(keypoints, np.float32)
        uv_shoulders = np_get_keypoints(kps_np, 'shoulder')
        uv_heads = np_get_keypoints(kps_np, 'head')
        uv_centers = np_get_keypoints(kps_np, 'center')
        xy_centers = np_pixel_to_camera(uv_centers, kk, 1)

        has_yaw = 'yaw' in dic_in
        if has_yaw:
            yaw_pred = np.asarray(dic_in['yaw'][0]).reshape(-1)
            yaw_orig = np.asarray(dic_in['yaw'][1]).reshape(-1)
        has_aux = 'aux' in dic_in

        for idx in all_idxs:
            kps = keypoints[idx]
            box = boxes[idx]
            dd_pred = float(np.asarray(dic_in['d'][idx]).reshape(-1)[0])
            bi = float(np.asarray(dic_in['bi'][idx]).reshape(-1)[0])
            var_y = float(np.asarray(dic_in['epi'][idx]).reshape(-1)[0])
            uu_s, vv_s = uv_shoulders[idx][0:2]
            uu_c, vv_c = uv_centers[idx][0:2]
            uu_h, vv_h = uv_heads[idx][0:2]
            xyz_pred = np_xyz_from_distance(dd_pred, xy_centers[idx])[0]
            distance = math.sqrt(float(xyz_pred[0]) ** 2 + float(xyz_pred[1]) ** 2
                                 + float(xyz_pred[2]) ** 2)
            conf = 0.035 * (box[-1]) / (bi / distance)

            dic_out['boxes'].append(box)
            dic_out['confs'].append(conf)
            dic_out['dds_pred'].append(dd_pred)
            dic_out['stds_ale'].append(bi)
            dic_out['stds_epi'].append(var_y)
            dic_out['xyz_pred'].append([float(x) for x in xyz_pred])
            dic_out['uv_kps'].append(kps)
            dic_out['uv_centers'].append([round(float(uu_c)), round(float(vv_c))])
            dic_out['uv_shoulders'].append([round(float(uu_s)), round(float(vv_s))])
            dic_out['uv_heads'].append([round(float(uu_h)), round(float(vv_h))])

            if has_yaw:
                dic_out['angles'].append(float(yaw_pred[idx]))
                dic_out['angles_egocentric'].append(float(yaw_orig[idx]))
                if has_aux:
                    dic_out['aux'].append(float(np.asarray(dic_in['aux'][idx]).reshape(-1)[0]))
                else:
                    # Schema quirk of the reference: its defaultdict touches
                    # dic_out['aux'] before the KeyError on dic_in['aux'], so
                    # mono outputs carry an empty "aux": [] that the
                    # byte-compat golden pins.
                    dic_out['aux']  # noqa: B018 — deliberate defaultdict touch
            else:
                # Same quirk for the legacy 2-output net: 'angles' is touched
                # before the KeyError on dic_in['yaw'].
                dic_out['angles']  # noqa: B018 — deliberate defaultdict touch

        for idx, idx_gt in matches:
            dd_real = dds_gt[idx_gt]
            xyz_real = np_xyz_from_distance(dd_real, xy_centers[idx])
            dic_out['dds_real'].append(dd_real)
            dic_out['boxes_gt'].append(boxes_gt[idx_gt])
            dic_out['xyz_real'].append([float(x) for x in xyz_real.squeeze()])
        return dic_out

    @staticmethod
    def social_distance(dic_out, args):
        """Flag social-distancing violations per person, from
        args.threshold_prob, args.threshold_dist and args.radii."""
        angles = dic_out['angles']
        dds = dic_out['dds_pred']
        stds = dic_out['stds_ale']
        xz_centers = [[xx[0], xx[2]] for xx in dic_out['xyz_pred']]
        dic_out['social_distance'] = [
            bool(social_interactions(idx, xz_centers, angles, dds, stds=stds,
                                     threshold_prob=args.threshold_prob,
                                     threshold_dist=args.threshold_dist,
                                     radii=args.radii))
            for idx, _ in enumerate(dic_out['xyz_pred'])
        ]
        return dic_out

    @staticmethod
    def raising_hand(dic_out, keypoints):
        dic_out['raising_hand'] = [is_raising_hand(kp) for kp in keypoints]
        return dic_out


def median_disparity(dic_out, keypoints, keypoints_r, mask=None):
    """Ablation: replace the stereo net's depth with the median joint
    disparity wherever a confident stereo match exists. dic_out['xyzd'] is
    updated (numpy) and dic_out returned.

    The winning right candidate per left keypoint comes from `mask` (an (m,
    r) selection matrix, the form `filter_outputs` returns) or, when mask is
    None, from dic_out['aux_idx'] as the engine's stereo `forward` returns
    it. Host numpy, a copy of the JAX package's."""
    keypoints = np.asarray(keypoints)
    keypoints_r = np.asarray(keypoints_r)
    if mask is None:
        idx_right = np.asarray(dic_out['aux_idx']).reshape(-1)
    else:
        idx_right = np.argmax(np.asarray(mask), axis=1)
    avg_disparities, _, _ = mask_joint_disparity(keypoints, keypoints_r)
    xyzd = np.asarray(dic_out['xyzd']).copy()
    for idx, aux in enumerate(np.asarray(dic_out['aux']).reshape(-1)):
        if aux > 0.5:
            idx_r = int(idx_right[idx])
            z = BF / avg_disparities[idx][idx_r]
            if 1 < z < 80:
                xyzd[idx][2] = z
                xyzd[idx][3] = np.linalg.norm(xyzd[idx][0:3])
    dic_out['xyzd'] = xyzd
    return dic_out
