"""`dryrun_multichip(n)`: one flagship stereo training step on a mesh of n
ranks, the counterpart of `__graft_entry__.dryrun_multichip`.

MonStereo's training configuration (68 -> 10, hidden 1024, 3 stages, batch
512 per data replica, the full stereo loss stack, Adam at lr 1e-3, dropout
0.2), on a dp x tp mesh: tp is 2 when n is even and above 1, else 1. The
weights are sharded by `loco_param_specs`, each data rank takes its rows,
and the step is `models.loco_forward_train_mesh` with its collectives.
`MONOLOCO_DRYRUN_TOY=1` selects the toy shapes (hidden 64, 2 stages, batch
4 n). Two steps run: the first pays the first use of every kernel, the
second is steady. Rank 0 returns the JAX package's line, which the caller
prints:

    dryrun_multichip(n): dp{dp}xtp{tp} train step ok (hidden H, S stages,
    batch B), loss=L, step wall Ts compile+exec / Ts steady

Run: python -c "from monoloco_tpu_torch.parallel.dryrun import dryrun_multichip;
dryrun_multichip(4)" (on the card, n cards; `device_type='cpu'` for gloo).
"""

import os
import time

import numpy as np
import torch

LR = 1e-3
P_DROPOUT = 0.2


def _batch(batch):
    """The JAX dry run's inputs and labels, from numpy seed 0."""
    rng = np.random.RandomState(0)
    x = rng.randn(batch, 68).astype(np.float32)
    y = np.concatenate([
        rng.randn(batch, 3).astype(np.float32),
        (np.abs(rng.randn(batch, 1)) + 5).astype(np.float32),
        rng.randn(batch, 6).astype(np.float32),
        (rng.rand(batch, 1) > 0.5).astype(np.float32),
    ], axis=1)
    return x, y


def _leaves(tree):
    out = []
    for k in sorted(tree):
        out.extend(_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])
    return out


def _step_worker(mesh, hidden, n_stage, batch):
    from ..models import (dropout_site_sharded, init_loco_params, loco_forward_train_mesh,
                          n_dropout_sites, params_from_numpy, train_keep_masks)
    from ..train.losses import LOSS_TASKS_STEREO, composite_losses, weighted_total
    from .mesh import loco_param_specs, reduce_loss, row_range, shard_by_specs

    device = mesh.device
    p_spec, bn_spec = loco_param_specs()
    params, bn_state = params_from_numpy(*init_loco_params(0, 68, 10, hidden, n_stage), device)
    params = shard_by_specs(params, mesh, p_spec)
    bn_state = shard_by_specs(bn_state, mesh, bn_spec)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    x, y = (torch.from_numpy(a).to(device) for a in _batch(batch))
    lo, hi = row_range(batch, mesh)
    x, y = x[lo:hi], y[lo:hi]
    gen = torch.Generator(device=device).manual_seed(1)
    width = hidden // mesh.tp
    cols = slice(mesh.model_rank * width, (mesh.model_rank + 1) * width)
    ones = torch.ones(hi - lo, device=device)
    walls = []
    for _ in range(2):
        sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
        sync()
        t0 = time.perf_counter()
        masks = train_keep_masks(batch, hidden, n_dropout_sites(n_stage), P_DROPOUT, gen, device)
        masks = [m[lo:hi, cols] if sharded else m[lo:hi]
                 for m, sharded in zip(masks, dropout_site_sharded(n_stage))]
        out, bn_state = loco_forward_train_mesh(params, bn_state, x, mesh, P_DROPOUT, masks)
        values = [reduce_loss(v * ((hi - lo) / batch), mesh)
                  for v in composite_losses(out, y, LOSS_TASKS_STEREO, phase='train', mask=ones)]
        loss, _ = weighted_total(values, (1.0,) * len(LOSS_TASKS_STEREO))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh.dp > 1:
            for t in leaves:
                torch.distributed.all_reduce(t.grad, group=mesh.data_group)
        optimizer.step()
        loss = float(loss.detach())
        sync()
        walls.append(time.perf_counter() - t0)
    kind = f"dp{mesh.dp}xtp{mesh.tp}" if mesh.tp > 1 else f"dp{mesh.dp}"
    return (f"dryrun_multichip({mesh.size}): {kind} train step ok "
            f"(hidden {hidden}, {n_stage} stages, batch {batch}), loss={loss:.4f}, "
            f"step wall {walls[0]:.2f}s compile+exec / {walls[1]:.3f}s steady")


def dryrun_multichip(n_devices, device_type='cuda', timeout=None):
    """One flagship (or, under MONOLOCO_DRYRUN_TOY=1, toy) stereo training
    step on n_devices ranks; prints and returns rank 0's line."""
    from .launch import launch
    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // tp
    toy = os.environ.get('MONOLOCO_DRYRUN_TOY') == '1'
    hidden, n_stage = (64, 2) if toy else (1024, 3)
    batch = 4 * n_devices if toy else 512 * dp
    line = launch(_step_worker, dp, tp, args=(hidden, n_stage, batch),
                  device_type=device_type, timeout=timeout)
    print(line)
    return line
