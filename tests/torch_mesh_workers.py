"""Rank functions of tests/test_torch_parallel.py. The mesh's other ranks are
spawned processes, which import these by name: this module imports torch
and the port only (no jax), so that they start quickly."""

import types

import numpy as np
import torch

from monoloco_tpu_torch.train import Trainer
from monoloco_tpu_torch.train import trainer as trainer_module

# The biases of the layers that feed a BatchNorm: their gradient is zero in
# exact arithmetic (BN removes the batch mean) and pure rounding in floats,
# which Adam divides by |g| + 1e-8 (tests/test_torch_train.py).
PRE_BN_BIASES = (('w1',), ('w3',), ('stages', 'w1'), ('stages', 'w2'))


class MeshTestTrainer(Trainer):
    """A Trainer that can start from given weights, take given epoch
    orders, and zero the pre-BN biases' gradients before each update."""

    def __init__(self, args, init=None, perms=None, zero_pre_bn=False):
        self._perms = perms
        self._zero_pre_bn = zero_pre_bn
        super().__init__(args)
        if init is not None:
            self.set_weights(*init)

    def set_weights(self, params, bn_state, log_sigmas=None):
        super().set_weights(params, bn_state, log_sigmas)
        if self._zero_pre_bn:
            step = self.optimizer.step

            def zeroed_step(*a, **kw):
                for path in PRE_BN_BIASES:
                    node = self.params
                    for key in path:
                        node = node[key]
                    node['b'].grad.zero_()
                return step(*a, **kw)
            self.optimizer.step = zeroed_step

    def _permutation(self, epoch):
        if self._perms is None:
            return super()._permutation(epoch)
        return torch.from_numpy(np.asarray(self._perms[epoch], np.int64)).to(self.device)


def train(mesh, args, init=None, perms=None, zero_pre_bn=False):
    """Train on this rank; rank 0 (or a lone run) returns the val losses of
    the best weights and the per-epoch logs."""
    args.mesh = mesh
    trainer = MeshTestTrainer(args, init, perms, zero_pre_bn)
    trainer.train()
    val = trainer.val_metrics().cpu().numpy()
    logs = {phase: {k: list(v) for k, v in trainer.epoch_losses[phase].items()}
            for phase in ('train', 'val')}
    return {'val': val, 'logs': logs, 'best_epoch': trainer.best_epoch,
            'n_steps': trainer.n_steps}


def _leaves_with_paths(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves_with_paths(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def step(mesh, args, x, y, init=None, masks=None, all_reduce=True):
    """One step of a Trainer from the weights `init` (its own init when
    None) on the global batch (x, y) with the global batch's keep-masks
    `masks`. Rank 0 (or a lone run) returns the loss, the gradients' global
    norm, the gradients before clipping and the weights after the step, the
    last two as {path: array}. all_reduce=False leaves out the all-reduce
    of the gradients over the data ranks: a seeded fault."""
    args.mesh = mesh
    trainer = MeshTestTrainer(args, init)
    grads = {}
    optimizer_step = trainer.optimizer.step

    def recording_step(*a, **kw):
        for path, t in _leaves_with_paths(trainer.params):
            grads[path] = t.grad.detach().cpu().numpy().copy()
        return optimizer_step(*a, **kw)
    trainer.optimizer.step = recording_step
    if not all_reduce:
        trainer_module.dist = types.SimpleNamespace(all_reduce=lambda *a, **kw: None)
    try:
        loss, gnorm, _ = trainer.step(torch.as_tensor(x, device=trainer.device),
                                      torch.as_tensor(y, device=trainer.device), masks=masks)
    finally:
        trainer_module.dist = torch.distributed
    gnorm = float(gnorm)
    unclip = 1.0 / min(1.0, trainer_module.GRAD_CLIP / (gnorm + 1e-6))
    return {'loss': float(loss), 'gnorm': gnorm,
            'grads': {path: g * unclip for path, g in grads.items()},
            'params': {path: t.detach().cpu().numpy()
                       for path, t in _leaves_with_paths(trainer.params)}}


def fail_on_rank_1(mesh):
    """Rank 1 raises before its first collective; rank 0 waits in one."""
    if mesh.rank == 1:
        raise ValueError('rank 1 fails on purpose')
    torch.distributed.barrier()
