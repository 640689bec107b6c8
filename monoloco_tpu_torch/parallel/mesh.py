"""Device meshes over torch.distributed: `monoloco_tpu/parallel/mesh.py` in
PyTorch's idiom.

The JAX package is one process over a `jax.sharding.Mesh`, and XLA's SPMD
partitioner inserts the collectives. Here each device is one process of a
`torch.distributed` process group (NCCL on the card, gloo on the CPU;
`parallel/launch.py` starts them), and the collectives are written where
SPMD inserted them:

- a `Mesh` is one rank's view of a (data, model) grid of ranks, data
  outermost (rank = data_rank * tp + model_rank), with the process group
  of each axis that holds this rank;
- `loco_param_specs` gives, for every leaf of the Loco model's params and
  BN state, the axes of its dims as the JAX package's PartitionSpecs do
  (a tuple of axis names and None; a dim named MODEL_AXIS is split over
  the model axis): Megatron's column-parallel and row-parallel layers in
  turn, stacked stages with a leading None, the BN state beside them;
- `shard_by_specs` and `gather_by_specs` take a full tree to this rank's
  slices and back; `shard_batch` gives this rank's rows;
- `copy_to_model`, `reduce_from_model`, `all_reduce_data` and `reduce_loss`
  are the autograd functions of the training collectives.

With one rank on an axis every helper is the identity, so the code that
takes a mesh runs unchanged from one device to many.
"""

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


class Mesh:
    """One rank's view of a (data=dp, model=tp) grid of ranks. Build it with
    `make_mesh` or `make_mesh_2d` inside an initialized process group (every
    rank builds it, in the same order: making a group is collective)."""

    def __init__(self, dp, tp, device):
        world = dist.get_world_size()
        if dp * tp != world:
            raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the process group "
                             f"has {world}")
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: tp}
        self.axis_names = (DATA_AXIS, MODEL_AXIS) if tp > 1 else (DATA_AXIS,)
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = divmod(self.rank, tp)
        self.device = torch.device(device)
        self.data_group = self.model_group = None
        for t in range(tp):
            group = dist.new_group([d * tp + t for d in range(dp)])
            if t == self.model_rank:
                self.data_group = group
        for d in range(dp):
            group = dist.new_group([d * tp + t for t in range(tp)])
            if d == self.data_rank:
                self.model_group = group

    @property
    def size(self):
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def dp(self):
        return self.shape[DATA_AXIS]

    @property
    def tp(self):
        return self.shape[MODEL_AXIS]

    @property
    def is_main(self):
        """Rank 0, the one rank that writes files and prints."""
        return self.rank == 0

    def __repr__(self):
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, device={self.device})"


def _rank_device(device):
    if device is not None:
        return torch.device(device)
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', dist.get_rank() % torch.cuda.device_count())
    return torch.device('cpu')


def make_mesh(device=None):
    """A 1-D data mesh over every rank of the process group."""
    return Mesh(dist.get_world_size(), 1, _rank_device(device))


def make_mesh_2d(dp, tp, device=None):
    """A (data=dp, model=tp) mesh. Data-parallel replicas ride the outer
    dimension, so a model group is tp consecutive ranks (on one host, the
    closest cards)."""
    return Mesh(dp, tp, _rank_device(device))


def loco_param_specs(axis=MODEL_AXIS):
    """The specs (params, bn_state) of the Loco model's tensor-parallel
    layout, mirroring `models/loco.py` `init_loco_params` and the JAX
    package's `loco_param_specs`.

    Megatron's alternation keeps the residual trunk feature-sharded with one
    collective pair a block: w1 column-parallel (hidden activations sharded
    over `axis`); each stage: w1 row-parallel (its block's activations
    replicated), w2 column-parallel (sharded again for the residual add);
    the head: w2 row-parallel (y2 replicated for the aux head), w3
    column-parallel, w_fin row-parallel (replicated outputs). Stage specs
    carry a leading None for the stacked stage axis."""
    col = {'w': (None, axis), 'b': (axis,)}
    row = {'w': (axis, None), 'b': ()}
    rep = {'w': (None, None), 'b': ()}
    bn_sharded = {'scale': (axis,), 'bias': (axis,)}
    bn_rep = {'scale': (), 'bias': ()}

    def stacked(spec):
        return {k: (None,) + v for k, v in spec.items()}

    params_spec = {
        'w1': col, 'bn1': bn_sharded, 'w2': row, 'w3': col, 'bn3': bn_sharded,
        'w_aux': rep, 'w_fin': row,
        'stages': {'w1': stacked(row), 'bn1': stacked(bn_rep), 'w2': stacked(col),
                   'bn2': stacked(bn_sharded)},
    }
    bn_state_spec = {
        'bn1': {'mean': (axis,), 'var': (axis,)},
        'bn3': {'mean': (axis,), 'var': (axis,)},
        'stages': {'bn1': {'mean': (None, None), 'var': (None, None)},
                   'bn2': {'mean': (None, axis), 'var': (None, axis)}},
    }
    return params_spec, bn_state_spec


def shard_dim(spec, axis=MODEL_AXIS):
    """The dim a spec splits over `axis`, or None."""
    return spec.index(axis) if axis in spec else None


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def spec_leaves(specs):
    """The specs' leaves in the order of `train/trainer.py` `_leaves` (keys
    sorted at every level)."""
    out = []
    for k in sorted(specs):
        v = specs[k]
        out.extend(spec_leaves(v) if isinstance(v, dict) else [v])
    return out


def _slice(x, dim, mesh):
    n = x.shape[dim] // mesh.tp
    return x.narrow(dim, mesh.model_rank * n, n).contiguous()


def shard_by_specs(tree, mesh, specs):
    """This rank's slice of every leaf of a full tree (tensors), split over
    the model axis as `specs` say; replicated leaves are kept whole."""
    def one(x, spec):
        dim = shard_dim(spec)
        return x if dim is None or mesh.tp == 1 else _slice(x, dim, mesh)
    return _map_specs(one, tree, specs)


def gather_by_specs(tree, mesh, specs):
    """The full tree from every rank's slices (an all-gather over the model
    group for each sharded leaf)."""
    def one(x, spec):
        dim = shard_dim(spec)
        if dim is None or mesh.tp == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.tp)]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim=dim)
    return _map_specs(one, tree, specs)


def row_range(n, mesh):
    """[lo, hi) of this rank's rows of n, contiguous and in data-rank order
    (equal shares when dp divides n)."""
    return n * mesh.data_rank // mesh.dp, n * (mesh.data_rank + 1) // mesh.dp


def shard_batch(arrays, mesh):
    """This rank's rows (`row_range`) of an array or tensor, or of each in a
    dict, list or tuple of them."""
    if isinstance(arrays, dict):
        return {k: shard_batch(v, mesh) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(shard_batch(v, mesh) for v in arrays)
    lo, hi = row_range(arrays.shape[0], mesh)
    return arrays[lo:hi]


def gather_rows(x, mesh):
    """The rows of every data rank in data-rank order: an all-gather over the
    data group of equal shares."""
    if mesh.dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# The training collectives, as autograd functions
# ---------------------------------------------------------------------------

def _all_reduce(x, group):
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


class _ReduceForward(torch.autograd.Function):
    """Sum over `group` forward; backward the identity, or with
    `backward_sums` a sum over the group too."""

    @staticmethod
    def forward(ctx, x, group, backward_sums):
        ctx.group, ctx.backward_sums = group, backward_sums
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return (_all_reduce(grad, ctx.group) if ctx.backward_sums else grad), None, None


class _ReduceBackward(torch.autograd.Function):
    """The identity forward, a sum over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_model(x, mesh):
    """The input of a column-parallel layer: the same x on every model rank,
    whose gradient is the sum of each rank's partial one."""
    return x if mesh.tp == 1 else _ReduceBackward.apply(x, mesh.model_group)


def reduce_from_model(x, mesh):
    """The output of a row-parallel layer: the sum of the model ranks'
    partial products; its gradient reaches each rank whole."""
    return x if mesh.tp == 1 else _ReduceForward.apply(x, mesh.model_group, False)


def all_reduce_data(x, mesh):
    """A sum over the data ranks of values that each rank's loss depends on
    (the BN batch statistics): each rank's part gets the sum of every
    rank's gradient."""
    return x if mesh.dp == 1 else _ReduceForward.apply(x, mesh.data_group, True)


def reduce_loss(x, mesh):
    """The global loss from each data rank's share (its rows' sum over the
    global row count). Every rank then holds the same loss, and its
    gradient reaches each share once: summing the model gradients over the
    data ranks afterwards gives the global gradient."""
    return x if mesh.dp == 1 else _ReduceForward.apply(x, mesh.data_group, False)
