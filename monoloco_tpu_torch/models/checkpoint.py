"""Checkpoint load/save for the port, compatible with the JAX package's files.

Native format (`FORMAT_TAG`): a pickle of numpy pytrees {'format', 'params',
'bn_state', 'meta'}, written by either package and read by both. The loader
also takes a reference PyTorch `state_dict`, converting the torch (out, in)
Linear layout into the (in, out) layout and stacking the per-stage blocks.

Trainer checkpoints of the JAX package also pickle `opt_state`, whose classes
live in optax (and may reference jax). A plain `pickle.load` would import
both, and neither is installed beside the port on the GPU machine. The
loader therefore unpickles through `_CheckpointUnpickler`, which maps every
optax/jax global to a placeholder that keeps its constructor arguments:
`opt_state` comes back as `(ScaleByAdamState(count, mu, nu),)` placeholders
whose `args` are those three, so `--resume` can take JAX's Adam moments.

The training blob (`save_train_state` / `load_train_state`) holds the JAX
keys ('params' and 'bn_state', the best-validation weights that serve;
'final_params', 'final_bn_state', 'log_sigmas', 'meta') and, instead of
optax's 'opt_state', the port's own resume state under 'torch_train_state'
(Adam's step and moments as numpy in the order of the trainable tree, the
update count, the trainer generator's state). The JAX loader reads the
weights of such a blob and resumes it with fresh Adam moments.

orbax directories (`.orbax`) are refused: `import orbax.checkpoint`
imports jax, which the port does not use.
"""

import importlib
import pickle

import numpy as np
import torch

from .loco import _stack

FORMAT_TAG = 'monoloco_tpu-v1'

_FOREIGN_ROOTS = ('optax', 'jax', 'jaxlib', 'chex', 'flax')
# The weight trees of a training blob (numpy leaves whatever they came as).
WEIGHT_KEYS = ('params', 'bn_state', 'final_params', 'final_bn_state')


ORBAX_REFUSAL = ("orbax checkpoints are not ported: `import orbax.checkpoint` imports jax, "
                 "which the port does not use (ROADMAP 'Not to port'; it was Queue 1 item 6); "
                 "use a .pkl path")


class _Inert:
    """Stands in for an optax/jax object inside a pickled training state.
    It keeps what it was built from: the positional constructor arguments
    in `args` (a namedtuple such as optax's `ScaleByAdamState` pickles its
    fields so), keywords in `kwargs`, a pickled state in `state`; `module`
    and `name` say which global it stands for."""

    module = name = None

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] in _FOREIGN_ROOTS:
            return type(name, (_Inert,), {'module': module, 'name': name})
        if module.startswith('numpy._core'):
            # Written by numpy 2; numpy 1 names the same module numpy.core.
            try:
                importlib.import_module(module)
            except ImportError:
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def _to_torch(tree, device='cpu'):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def params_from_numpy(params, bn_state, device='cpu'):
    """The JAX package's (params, bn_state) — pytrees of numpy or jax arrays
    (or tensors) — as the port's f32 tensor dicts on `device`, same keys and
    layout."""
    return _to_torch(params, device), _to_torch(bn_state, device)


def save_checkpoint(path, params, bn_state, meta=None, extra=None):
    """Save (params, bn_state, meta) as the native pickle (numpy leaves, so
    the JAX package loads it too); `extra` adds keys beside them. Orbax
    directories are refused."""
    save_train_state(path, {'params': params, 'bn_state': bn_state, 'meta': meta or {},
                            **(extra or {})})


def _to_numpy_blob(value):
    """Every tensor of a nested dict/list/tuple as numpy; other leaves (the
    meta's strings and numbers, numpy arrays) as they are."""
    if isinstance(value, dict):
        return {k: _to_numpy_blob(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy_blob(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def save_train_state(path, blob):
    """Pickle a training blob ({'params', 'bn_state', 'meta', ...}), every
    tensor as numpy, with the format tag: readable without torch, by the
    JAX package too."""
    if str(path).endswith('.orbax'):
        raise NotImplementedError(ORBAX_REFUSAL)
    out = {'format': FORMAT_TAG}
    for key, value in blob.items():
        if key in WEIGHT_KEYS:
            out[key] = _to_numpy(value)
        elif key != 'format':
            out[key] = _to_numpy_blob(value)
    out.setdefault('meta', {})
    with open(path, 'wb') as f:
        pickle.dump(out, f)


def load_train_state(path):
    """The whole training blob of a native pickle, the port's or the JAX
    package's, as a dict of numpy trees (optax objects as `_Inert`
    placeholders keeping their arguments). Raises ValueError for a file
    that is not a native checkpoint."""
    if str(path).endswith('.orbax'):
        raise NotImplementedError(ORBAX_REFUSAL)
    with open(path, 'rb') as f:
        blob = _CheckpointUnpickler(f).load()
    if not (isinstance(blob, dict) and blob.get('format') == FORMAT_TAG):
        raise ValueError(f"{path} is not a {FORMAT_TAG} training checkpoint")
    return blob


def load_checkpoint(path, device='cpu'):
    """Load a native pickle or a reference torch state_dict.
    Returns (params, bn_state, meta) with f32 tensors on `device`."""
    if str(path).endswith('.orbax'):
        raise NotImplementedError(ORBAX_REFUSAL)
    try:
        with open(path, 'rb') as f:
            blob = _CheckpointUnpickler(f).load()
        if isinstance(blob, dict) and blob.get('format') == FORMAT_TAG:
            params, bn_state = params_from_numpy(blob['params'], blob['bn_state'],
                                                 device)
            return params, bn_state, blob.get('meta', {})
    except (pickle.UnpicklingError, ModuleNotFoundError, AttributeError, EOFError):
        pass

    state = torch.load(path, map_location='cpu')
    if hasattr(state, 'state_dict'):
        state = state.state_dict()
    np_state = {k: v.detach().cpu().numpy() for k, v in state.items()
                if 'num_batches_tracked' not in k}
    # The key set tells the two reference architectures apart ('w3' exists
    # only in the Loco model).
    arch = 'loco' if 'w3.weight' in np_state else 'monoloco'
    params, bn_state = convert_torch_state_dict(np_state, arch=arch)
    params, bn_state = _to_torch(params, device), _to_torch(bn_state, device)
    net = 'monoloco' if arch == 'monoloco' else None
    return params, bn_state, {'source': 'torch', 'net': net}


def _linear(sd, prefix):
    return {'w': torch.as_tensor(np.asarray(sd[prefix + '.weight']).T.copy()),
            'b': torch.as_tensor(np.asarray(sd[prefix + '.bias']))}


def _bn(sd, prefix):
    return (
        {'scale': torch.as_tensor(np.asarray(sd[prefix + '.weight'])),
         'bias': torch.as_tensor(np.asarray(sd[prefix + '.bias']))},
        {'mean': torch.as_tensor(np.asarray(sd[prefix + '.running_mean'])),
         'var': torch.as_tensor(np.asarray(sd[prefix + '.running_var']))},
    )


def convert_torch_state_dict(sd, arch='loco'):
    """Convert a reference state_dict (numpy values) into (params, bn_state)
    tensor dicts in the (in, out) layout."""
    num_stage = len({k.split('.')[1] for k in sd if k.startswith('linear_stages.')})
    stage_p, stage_s = [], []
    for i in range(num_stage):
        pre = f'linear_stages.{i}'
        b1p, b1s = _bn(sd, f'{pre}.batch_norm1')
        b2p, b2s = _bn(sd, f'{pre}.batch_norm2')
        stage_p.append({'w1': _linear(sd, f'{pre}.w1'), 'bn1': b1p,
                        'w2': _linear(sd, f'{pre}.w2'), 'bn2': b2p})
        stage_s.append({'bn1': b1s, 'bn2': b2s})

    bn1p, bn1s = _bn(sd, 'batch_norm1')
    if arch == 'loco':
        bn3p, bn3s = _bn(sd, 'batch_norm3')
        params = {
            'w1': _linear(sd, 'w1'), 'bn1': bn1p,
            'w2': _linear(sd, 'w2'), 'w3': _linear(sd, 'w3'), 'bn3': bn3p,
            'w_aux': _linear(sd, 'w_aux'), 'w_fin': _linear(sd, 'w_fin'),
            'stages': _stack(stage_p),
        }
        bn_state = {'bn1': bn1s, 'bn3': bn3s, 'stages': _stack(stage_s)}
    elif arch == 'monoloco':
        params = {
            'w1': _linear(sd, 'w1'), 'bn1': bn1p,
            'w2': _linear(sd, 'w2'),
            'stages': _stack(stage_p),
        }
        bn_state = {'bn1': bn1s, 'stages': _stack(stage_s)}
    else:
        raise ValueError(arch)
    return params, bn_state
