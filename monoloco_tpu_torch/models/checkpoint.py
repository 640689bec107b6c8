"""Checkpoint load/save for the port, compatible with the JAX package's files.

Native format (`FORMAT_TAG`): a pickle of numpy pytrees {'format', 'params',
'bn_state', 'meta'}, written by either package and read by both. The loader
also takes a reference PyTorch `state_dict`, converting the torch (out, in)
Linear layout into the (in, out) layout and stacking the per-stage blocks.

Trainer checkpoints of the JAX package also pickle `opt_state`, whose classes
live in optax (and may reference jax). A plain `pickle.load` would import
both, and neither is installed beside the port on the GPU machine. The
loader therefore unpickles through `_CheckpointUnpickler`, which maps every
optax/jax global to an inert placeholder, and keeps only 'params',
'bn_state' and 'meta'.
"""

import importlib
import pickle

import numpy as np
import torch

from .loco import _stack

FORMAT_TAG = 'monoloco_tpu-v1'

_FOREIGN_ROOTS = ('optax', 'jax', 'jaxlib', 'chex', 'flax')


class _Inert:
    """Stands in for an optax/jax object inside a pickled training state:
    accepts any constructor or state and holds nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] in _FOREIGN_ROOTS:
            return _Inert
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
    the JAX package loads it too); `extra` adds keys beside them (the
    trainer's 'log_sigmas'). Orbax directories are not written here."""
    if str(path).endswith('.orbax'):
        raise NotImplementedError(
            "orbax checkpoints are not ported (ROADMAP Queue 1, training)")
    blob = {
        'format': FORMAT_TAG,
        'params': _to_numpy(params),
        'bn_state': _to_numpy(bn_state),
        'meta': meta or {},
        **(extra or {}),
    }
    with open(path, 'wb') as f:
        pickle.dump(blob, f)


def load_checkpoint(path, device='cpu'):
    """Load a native pickle or a reference torch state_dict.
    Returns (params, bn_state, meta) with f32 tensors on `device`."""
    if str(path).endswith('.orbax'):
        raise NotImplementedError(
            "orbax checkpoints are not ported (ROADMAP Queue 1, training)")
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
