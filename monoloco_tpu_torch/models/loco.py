"""The Loco (MonoLoco++) residual MLP in torch: init, the eval and training
forwards, BN fold.

Counterpart of `monoloco_tpu/models/loco.py`. Parameters are nested dicts of
tensors with the JAX package's keys and its (in, out) weight layout, so
`x @ W` and the tests compare like with like; the residual stages are stacked
along a leading axis (S, ...). The trees map one to one onto the JAX
package's `params` and `bn_state` (`checkpoint.params_from_numpy` one way,
the numpy export of `save_checkpoint` the other).

`loco_forward_train` is the training forward: BatchNorm from the batch's
statistics (optionally over the rows a mask keeps) with torch's running-stat
update (eps 1e-5, momentum 0.1, unbiased running variance), and dropout
after each ReLU, `where(keep, h / (1 - p), 0)`, as the JAX package's
`loco_forward(train=True)`.

`fold_eval_params` folds eval-mode BN into the preceding linear; the folded
forward is the chain the dyn8 kernel (ops/fused_mlp.py) computes:
  y = relu(x @ W0 + b0)
  for each stage: y += relu(relu(y @ Wa + ba) @ Wb + bb)
  y2 = y @ W2 + b2;  aux = y2 @ Waux + baux
  fin = relu(y2 @ W3f + b3f) @ Wfin + bfin
  out = [fin, aux]
"""

import math

import numpy as np
import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _init_linear(rng, fan_in, fan_out):
    bound = 1.0 / math.sqrt(fan_in)
    return {
        'w': torch.from_numpy(rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)),
        'b': torch.from_numpy(rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)),
    }


def _stack(trees):
    """Stack a list of equally-shaped nested dicts along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_loco_params(seed, input_size, output_size, linear_size=1024, num_stage=3):
    """Initialize the Loco (MonoLoco++) model from a numpy seed with torch
    nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BN scale 1, bias
    0, running mean 0, var 1. Returns (params, bn_state)."""
    rng = np.random.default_rng(seed)
    h = linear_size

    def bn():
        return {'scale': torch.ones(h), 'bias': torch.zeros(h)}

    def bn_state():
        return {'mean': torch.zeros(h), 'var': torch.ones(h)}

    params = {
        'w1': _init_linear(rng, input_size, h),
        'bn1': bn(),
        'w2': _init_linear(rng, h, h),
        'w3': _init_linear(rng, h, h),
        'bn3': bn(),
        'w_aux': _init_linear(rng, h, 1),
        'w_fin': _init_linear(rng, h, output_size - 1),
        'stages': _stack([
            {'w1': _init_linear(rng, h, h), 'bn1': bn(),
             'w2': _init_linear(rng, h, h), 'bn2': bn()}
            for _ in range(num_stage)
        ]),
    }
    state = {
        'bn1': bn_state(),
        'bn3': bn_state(),
        'stages': _stack([{'bn1': bn_state(), 'bn2': bn_state()}
                          for _ in range(num_stage)]),
    }
    return params, state


def init_monoloco_params(seed, input_size, output_size, linear_size=256, num_stage=3):
    """Initialize the legacy MonoLoco net (34 -> 2 in the reference: a
    Linear + BN + ReLU, the residual stages, one output Linear) from a
    numpy seed, as `init_loco_params` does. Returns (params, bn_state) with
    the JAX package's `init_monoloco_params` keys."""
    rng = np.random.default_rng(seed)
    h = linear_size

    def bn():
        return {'scale': torch.ones(h), 'bias': torch.zeros(h)}

    def bn_state():
        return {'mean': torch.zeros(h), 'var': torch.ones(h)}

    params = {
        'w1': _init_linear(rng, input_size, h),
        'bn1': bn(),
        'w2': _init_linear(rng, h, output_size),
        'stages': _stack([
            {'w1': _init_linear(rng, h, h), 'bn1': bn(),
             'w2': _init_linear(rng, h, h), 'bn2': bn()}
            for _ in range(num_stage)
        ]),
    }
    state = {'bn1': bn_state(),
             'stages': _stack([{'bn1': bn_state(), 'bn2': bn_state()}
                               for _ in range(num_stage)])}
    return params, state


def _dense(p, x):
    return x @ p['w'] + p['b']


def _batch_norm_eval(p, state, x):
    y = (x - state['mean']) * torch.rsqrt(state['var'] + BN_EPS)
    return y * p['scale'] + p['bias']


def loco_forward(params, bn_state, x):
    """Eval forward of the unfolded Loco model (BN from running stats, no
    dropout). Returns (m, out) outputs ordered [fin..., aux]."""
    y = torch.relu(_batch_norm_eval(params['bn1'], bn_state['bn1'],
                                    _dense(params['w1'], x)))
    sp, ss = params['stages'], bn_state['stages']
    for i in range(sp['w1']['w'].shape[0]):
        def at(tree):
            return {k: at(v) if isinstance(v, dict) else v[i] for k, v in tree.items()}
        p, s = at(sp), at(ss)
        h = torch.relu(_batch_norm_eval(p['bn1'], s['bn1'], _dense(p['w1'], y)))
        h = torch.relu(_batch_norm_eval(p['bn2'], s['bn2'], _dense(p['w2'], h)))
        y = y + h
    y2 = _dense(params['w2'], y)
    aux = _dense(params['w_aux'], y2)
    y3 = torch.relu(_batch_norm_eval(params['bn3'], bn_state['bn3'],
                                     _dense(params['w3'], y2)))
    fin = _dense(params['w_fin'], y3)
    return torch.cat([fin, aux], dim=1)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _dense_train(p, x):
    """x @ W + b for training. Under autocast (bf16) the product runs in bf16
    and its output comes back as f32, so BN, the residual and the loss stay
    f32."""
    y = torch.addmm(p['b'], x, p['w'])
    return y if y.dtype == torch.float32 else y.float()


def _batch_norm_train(p, state, x, row_mask):
    """Training-mode BatchNorm1d. `state` ({'mean', 'var'}, a fresh copy)
    takes the running-stat update in place. Without `row_mask` this is
    `F.batch_norm`; with it, the statistics cover the rows the (m,) 0/1 mask
    keeps: the biased variance normalizes, the unbiased one (n - 1, at least
    1) enters the running variance. A batch of one row takes the masked
    path, as `F.batch_norm` refuses it and the JAX package computes it."""
    if row_mask is None and x.shape[0] > 1:
        return nn.functional.batch_norm(x, state['mean'], state['var'], p['scale'], p['bias'],
                                        training=True, momentum=BN_MOMENTUM, eps=BN_EPS)
    if row_mask is None:
        row_mask = torch.ones(x.shape[0], device=x.device)
    w = row_mask[:, None]
    n = row_mask.sum()
    mean = (x * w).sum(dim=0) / n
    var = (((x - mean) ** 2) * w).sum(dim=0) / n
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    with torch.no_grad():
        unbiased = var * (n / torch.clamp(n - 1, min=1))
        state['mean'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        state['var'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
    return y * p['scale'] + p['bias']


def _batch_norm_train_mesh(p, state, x, mesh):
    """Training-mode BatchNorm over the rows of every data rank: the sum and
    then the squared deviations from the global mean are summed over the
    data group (`all_reduce_data`, whose gradient is summed too), so the
    statistics, the normalization and the running-stat update are those of
    the global batch. x holds this rank's rows (possibly none) and this
    rank's features (a shard under tp, or all of them)."""
    from ..parallel import all_reduce_data
    n = all_reduce_data(torch.tensor(float(x.shape[0]), device=x.device), mesh)
    mean = all_reduce_data(x.sum(dim=0), mesh) / n
    var = all_reduce_data(((x - mean) ** 2).sum(dim=0), mesh) / n
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    with torch.no_grad():
        unbiased = var * (n / torch.clamp(n - 1, min=1))
        state['mean'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        state['var'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
    return y * p['scale'] + p['bias']


def dropout_site_sharded(n_stage):
    """Whether each dropout site of `n_dropout_sites` order sees features
    sharded over the model axis under `loco_param_specs`: after the input
    layer yes; in each stage after its row-parallel w1 no (replicated),
    after its column-parallel w2 yes; after w3 yes."""
    return [True] + [False, True] * n_stage + [True]


def loco_forward_train_mesh(params, bn_state, x, mesh, p_dropout=0.2, masks=None):
    """The training forward of the Loco model on a mesh (`parallel/mesh.py`):
    x this rank's rows, `params` and `bn_state` this rank's shards by
    `loco_param_specs`, `masks` the keep-masks of this rank's rows and, at
    the sharded sites (`dropout_site_sharded`), of its feature shard.
    Megatron's layout: column-parallel layers take their input through
    `copy_to_model`, row-parallel ones sum their partial products with
    `reduce_from_model` and add their bias after it; BatchNorm takes the
    global batch's statistics (`_batch_norm_train_mesh`). Returns
    (outputs (rows, out), replicated over the model axis, [fin..., aux];
    new_bn_state, this rank's shards)."""
    from ..parallel import copy_to_model, reduce_from_model
    new_state = _tree_clone(bn_state)
    n_stage = params['stages']['w1']['w'].shape[0]
    sites = iter(masks if p_dropout > 0 else ())

    def relu_drop(h):
        h = torch.relu(h)
        if p_dropout > 0:
            h = torch.where(next(sites), h / (1.0 - p_dropout), 0.0)
        return h

    def column(p, a):
        return _dense_train(p, copy_to_model(a, mesh))

    def row(p, a):
        if mesh.tp == 1:
            return _dense_train(p, a)
        y = a @ p['w']
        return reduce_from_model(y if y.dtype == torch.float32 else y.float(), mesh) + p['b']

    def at(tree, i):
        return {k: at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    y = relu_drop(_batch_norm_train_mesh(params['bn1'], new_state['bn1'],
                                         column(params['w1'], x), mesh))
    for i in range(n_stage):
        sp, ss = at(params['stages'], i), at(new_state['stages'], i)
        h = relu_drop(_batch_norm_train_mesh(sp['bn1'], ss['bn1'], row(sp['w1'], y), mesh))
        h = relu_drop(_batch_norm_train_mesh(sp['bn2'], ss['bn2'], column(sp['w2'], h), mesh))
        y = y + h
    y2 = row(params['w2'], y)
    aux = _dense_train(params['w_aux'], y2)
    y3 = relu_drop(_batch_norm_train_mesh(params['bn3'], new_state['bn3'],
                                          column(params['w3'], y2), mesh))
    fin = row(params['w_fin'], y3)
    return torch.cat([fin, aux], dim=1), new_state


def train_keep_masks(rows, hidden, n_sites, p_dropout, generator, device):
    """One training step's keep-masks: `n_sites` bool (rows, hidden) tensors,
    True with probability 1 - p_dropout, drawn from `generator` (on
    `device`) site by site in `n_dropout_sites` order."""
    return [torch.rand((rows, hidden), generator=generator, device=device) < 1.0 - p_dropout
            for _ in range(n_sites)]


def loco_forward_train(params, bn_state, x, p_dropout=0.2, masks=None, row_mask=None,
                       generator=None):
    """The training forward of the Loco model. Returns (outputs (m, out)
    ordered [fin..., aux], new_bn_state).

    Dropout after each ReLU, with p_dropout > 0 only: `masks` are the keep
    masks in `n_dropout_sites` order (each broadcastable to (m, hidden));
    without them they are drawn from `generator` (`train_keep_masks`).
    `row_mask` (m,) of 0/1 keeps padded rows out of the BN statistics. The
    running stats of `bn_state` are not touched: the update lands in a copy.
    """
    new_state = _tree_clone(bn_state)
    hidden = params['w1']['w'].shape[1]
    n_stage = params['stages']['w1']['w'].shape[0]
    if p_dropout > 0 and masks is None:
        masks = train_keep_masks(x.shape[0], hidden, n_dropout_sites(n_stage), p_dropout,
                                 generator, x.device)
    sites = iter(masks if p_dropout > 0 else ())

    def relu_drop(h):
        h = torch.relu(h)
        if p_dropout > 0:
            h = torch.where(next(sites), h / (1.0 - p_dropout), 0.0)
        return h

    def unbind(tree):
        return ({k: unbind(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.unbind(0))

    def at(tree, i):
        return {k: at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    y = relu_drop(_batch_norm_train(params['bn1'], new_state['bn1'],
                                    _dense_train(params['w1'], x), row_mask))
    stages = unbind(params['stages'])
    for i in range(n_stage):
        sp, ss = at(stages, i), at(new_state['stages'], i)
        h = relu_drop(_batch_norm_train(sp['bn1'], ss['bn1'], _dense_train(sp['w1'], y),
                                        row_mask))
        h = relu_drop(_batch_norm_train(sp['bn2'], ss['bn2'], _dense_train(sp['w2'], h),
                                        row_mask))
        y = y + h
    y2 = _dense_train(params['w2'], y)
    aux = _dense_train(params['w_aux'], y2)
    y3 = relu_drop(_batch_norm_train(params['bn3'], new_state['bn3'],
                                     _dense_train(params['w3'], y2), row_mask))
    fin = _dense_train(params['w_fin'], y3)
    return torch.cat([fin, aux], dim=1), new_state


def _stage_at(tree, i):
    """Stage i of a trial-stacked tree, whose stage leaves are (T, S, ...)."""
    return {k: _stage_at(v, i) if isinstance(v, dict) else v[:, i] for k, v in tree.items()}


def _dense_stacked(p, x):
    """x (T, m, in), or (m, in) shared by the trials, through each trial's
    layer: W (T, in, out), b (T, out) -> (T, m, out), f32 as `_dense_train`."""
    if x.dim() == 2:
        x = x.expand(p['w'].shape[0], *x.shape)
    y = torch.baddbmm(p['b'][:, None, :], x, p['w'])
    return y if y.dtype == torch.float32 else y.float()


def _batch_norm_train_stacked(p, state, x):
    """Training-mode BatchNorm of each trial over its own rows: x (T, m, H),
    p and `state` (T, H) (a fresh copy whose running stats are updated in
    place). Each trial runs `_batch_norm_train` on its slice (one
    `F.batch_norm` a trial, which takes one set of channels and has no
    batched form with running stats), so its statistics, running-stat
    update and rounding are those of a lone trial's step."""
    return torch.stack([
        _batch_norm_train({'scale': p['scale'][k], 'bias': p['bias'][k]},
                          {'mean': state['mean'][k], 'var': state['var'][k]}, x[k], None)
        for k in range(x.shape[0])])


def _batch_norm_eval_stacked(p, state, x):
    y = (x - state['mean'][:, None, :]) * torch.rsqrt(state['var'][:, None, :] + BN_EPS)
    return y * p['scale'][:, None, :] + p['bias'][:, None, :]


def loco_forward_train_stacked(params, bn_state, x, p_dropout=0.2, masks=None,
                               generator=None):
    """The training forward of T Loco models of one shape at once, each leaf
    of `params` and `bn_state` with a leading trial axis (stage leaves (T,
    S, ...)), on rows x (m, in) that every trial shares. Each product is one
    `torch.baddbmm` over the trials; BatchNorm takes each trial's own batch
    statistics (`_batch_norm_train_stacked`); the keep-masks (m, hidden) are
    shared by the trials, drawn from `generator` as `loco_forward_train`
    draws them when not given.
    Returns (outputs (T, m, out) ordered [fin..., aux], new_bn_state)."""
    new_state = _tree_clone(bn_state)
    hidden = params['w1']['w'].shape[2]
    n_stage = params['stages']['w1']['w'].shape[1]
    if p_dropout > 0 and masks is None:
        masks = train_keep_masks(x.shape[0], hidden, n_dropout_sites(n_stage), p_dropout,
                                 generator, x.device)
    sites = iter(masks if p_dropout > 0 else ())

    def relu_drop(h):
        h = torch.relu(h)
        if p_dropout > 0:
            h = torch.where(next(sites), h / (1.0 - p_dropout), 0.0)
        return h

    y = relu_drop(_batch_norm_train_stacked(params['bn1'], new_state['bn1'],
                                            _dense_stacked(params['w1'], x)))
    for i in range(n_stage):
        sp, ss = _stage_at(params['stages'], i), _stage_at(new_state['stages'], i)
        h = relu_drop(_batch_norm_train_stacked(sp['bn1'], ss['bn1'],
                                                _dense_stacked(sp['w1'], y)))
        h = relu_drop(_batch_norm_train_stacked(sp['bn2'], ss['bn2'],
                                                _dense_stacked(sp['w2'], h)))
        y = y + h
    y2 = _dense_stacked(params['w2'], y)
    aux = _dense_stacked(params['w_aux'], y2)
    y3 = relu_drop(_batch_norm_train_stacked(params['bn3'], new_state['bn3'],
                                             _dense_stacked(params['w3'], y2)))
    fin = _dense_stacked(params['w_fin'], y3)
    return torch.cat([fin, aux], dim=2), new_state


def loco_forward_stacked(params, bn_state, x):
    """Eval forward of T trial-stacked Loco models on shared rows x (m, in):
    (T, m, out), each trial's BN from its running stats."""
    y = torch.relu(_batch_norm_eval_stacked(params['bn1'], bn_state['bn1'],
                                            _dense_stacked(params['w1'], x)))
    for i in range(params['stages']['w1']['w'].shape[1]):
        sp, ss = _stage_at(params['stages'], i), _stage_at(bn_state['stages'], i)
        h = torch.relu(_batch_norm_eval_stacked(sp['bn1'], ss['bn1'],
                                                _dense_stacked(sp['w1'], y)))
        h = torch.relu(_batch_norm_eval_stacked(sp['bn2'], ss['bn2'],
                                                _dense_stacked(sp['w2'], h)))
        y = y + h
    y2 = _dense_stacked(params['w2'], y)
    aux = _dense_stacked(params['w_aux'], y2)
    y3 = torch.relu(_batch_norm_eval_stacked(params['bn3'], bn_state['bn3'],
                                             _dense_stacked(params['w3'], y2)))
    return torch.cat([_dense_stacked(params['w_fin'], y3), aux], dim=2)


def _fold(linear, bn, bn_state):
    """Fold eval-mode BN into the preceding linear: y = BN(xW + b). Works for
    single (in, out) and stacked (S, in, out) layers."""
    scale = bn['scale'] / torch.sqrt(bn_state['var'] + BN_EPS)
    return {
        'w': linear['w'] * scale[..., None, :],
        'b': (linear['b'] - bn_state['mean']) * scale + bn['bias'],
    }


def fold_eval_params(params, bn_state, arch='loco'):
    """Collapse BN into affine layers for inference ('loco', or the legacy
    'monoloco' net whose head is a single Linear)."""
    folded = {
        'l0': _fold(params['w1'], params['bn1'], bn_state['bn1']),
        'stages': {
            'a': _fold(params['stages']['w1'], params['stages']['bn1'],
                       bn_state['stages']['bn1']),
            'b': _fold(params['stages']['w2'], params['stages']['bn2'],
                       bn_state['stages']['bn2']),
        },
        'w2': dict(params['w2']),
    }
    if arch == 'monoloco':
        return folded
    if arch != 'loco':
        raise ValueError(arch)
    folded.update({
        'w_aux': dict(params['w_aux']),
        'w3f': _fold(params['w3'], params['bn3'], bn_state['bn3']),
        'w_fin': dict(params['w_fin']),
    })
    return folded


def round_bf16(t):
    """t rounded to bf16 and back to f32 (nearest, ties to even)."""
    return t.to(torch.bfloat16).float()


def _folded_chain(folded, x, arch, dense, act):
    """The folded net with `dense(layer, a)` for each affine layer and
    `act(h)` for each ReLU (and, for MC dropout, the dropout after it)."""
    y = act(dense(folded['l0'], x))
    st = folded['stages']
    for i in range(st['a']['w'].shape[0]):
        h = act(dense({'w': st['a']['w'][i], 'b': st['a']['b'][i]}, y))
        h = act(dense({'w': st['b']['w'][i], 'b': st['b']['b'][i]}, h))
        y = y + h
    if arch == 'monoloco':
        return dense(folded['w2'], y)
    y2 = dense(folded['w2'], y)
    aux = dense(folded['w_aux'], y2)
    fin = dense(folded['w_fin'], act(dense(folded['w3f'], y2)))
    return torch.cat([fin, aux], dim=-1)


def folded_forward(folded, x, arch='loco', operand=None):
    """Plain f32 folded eval forward (`torch.matmul`, as the JAX package leaves
    this path to XLA). With `operand` (e.g. `round_bf16`), each product's
    activation and weight pass through it first: with bf16 rounding the
    products are exact in f32 and summed in f32 (TF32 off), the arithmetic
    of the bfloat16 matmul precision; biases and the residual stay f32."""
    if operand is None:
        return _folded_chain(folded, x, arch, _dense, torch.relu)
    return _folded_chain(folded, x, arch,
                         lambda p, a: operand(a) @ operand(p['w']) + p['b'], torch.relu)


def n_dropout_sites(n_stage, arch='loco'):
    """Dropout call sites of one MC pass, in forward order: after the input
    layer, two per stage, and for 'loco' after w3 (2S + 2; 'monoloco' 2S +
    1), as `_dropout` is called in the JAX package's `loco_forward` and
    `monoloco_forward`."""
    return 2 * n_stage + (2 if arch == 'loco' else 1)


def dropout_masks(n_passes, rows, hidden, n_sites, p_dropout, device, seed=0):
    """Keep-masks for MC dropout: `n_sites` bool tensors (n_passes, rows,
    hidden), True with probability 1 - p_dropout, drawn site by site from a
    torch.Generator on `device` seeded with `seed` (made afresh on every
    call, so a call is reproducible on one device; it does not reproduce
    JAX's key tree)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand((n_passes, rows, hidden), generator=gen, device=device) < 1.0 - p_dropout
            for _ in range(n_sites)]


def folded_forward_mc(folded, x, masks, p_dropout, arch='loco'):
    """The MC-dropout forward on the folded net: BN in eval mode (folded,
    exact in real arithmetic), and after each ReLU of a dropout site
    `where(keep, h / (1 - p), 0)`, as the JAX package's `_dropout`. x (...,
    rows, in) f32; `masks` in `n_dropout_sites` order, each (n, ..., rows,
    H) or broadcastable to it, which puts the passes on a leading axis.
    Returns (n, ..., rows, out), [fin, aux] for 'loco'."""
    sites = iter(masks)

    def relu_drop(h):
        return torch.where(next(sites), torch.relu(h) / (1.0 - p_dropout), 0.0)

    return _folded_chain(folded, x, arch, _dense, relu_drop)


def _flatten(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f'{prefix}{k}.'))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split('.')
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class FoldedLoco(nn.Module):
    """The folded eval network as a module: the folded tensors are buffers
    (the slice serves and does not train), so `.to(device)` moves them and
    `forward` is `folded_forward`."""

    def __init__(self, folded, arch='loco'):
        super().__init__()
        self.arch = arch
        self._names = {}
        for i, (key, v) in enumerate(_flatten(folded).items()):
            name = f'folded_{i}'
            self._names[name] = key
            self.register_buffer(name, torch.as_tensor(v, dtype=torch.float32))

    def folded(self):
        """The folded dict ({'l0': {'w', 'b'}, 'stages': ..., ...})."""
        return _unflatten({key: getattr(self, name)
                           for name, key in self._names.items()})

    def forward(self, x):
        return folded_forward(self.folded(), x, arch=self.arch)
