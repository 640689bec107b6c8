"""Mesh scaling: dp1/2/4/... step walls at a fixed total batch.

Counterpart of the JAX package's `tools/bench_mesh_scaling.py`. With a FIXED
total batch every dp width does the same operations, so a step wall that
grows with dp is the cost of partitioning and collectives; a serialization
shows as a large ratio. The verdict is the JAX tool's: OK when the widest
width's median wall is at most 1.5x dp1's, else PATHOLOGICAL (exit code 1).

Each width runs in a fresh interpreter, and in it a mesh of that many ranks
through `parallel/launch.py` (NCCL, one rank a card; gloo with
`--disable-cuda`). Every rank starts from the same weights (MonStereo 68 ->
10, `init_loco_params(0, ...)`, hidden `--hidden`, 3 stages) and takes its
rows of the same batch (numpy seed 0, the JAX child's draws, as the dry
run's `parallel/dryrun.py` draws them). The defaults are the size the port
trains (bs 512, hidden 1024, 3 stages), the JAX tool's usage line; its own
defaults (256 and 256) were sized for a one-core CPU host, and on a card a
step that small is launch overhead, which would hide what partitioning and
the collectives cost. Two
measurements, each the median of `--reps` timed repetitions after one
warm-up, ending in a device synchronization:
  train  one training step: the forward with dropout 0.2 (keep-masks from a
         generator every rank shares), the stereo loss stack reduced over
         the data ranks, backward, the gradients all-reduced, Adam at 1e-3;
  serve  the BN-folded forward of each rank's rows, its sum all-reduced and
         fetched (the mesh-sharded serving forward).

    python -m monoloco_tpu_torch.tools.bench_mesh_scaling [--widths 1,2,4,8]
        [--batch 512] [--hidden 1024] [--reps 5] [--disable-cuda]

The default widths are the powers of two up to the device count (8 on the
CPU). A width beyond the cards available is refused with an error naming
it; nothing is skipped. Prints one JSON line per measurement, with the JAX
tool's keys, then a verdict line per measurement.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

from . import REPO, device_name, sync

BATCH, HIDDEN = 512, 1024      # the JAX tool's usage line: the port's training size
RATIO_LIMIT = 1.5
CPU_WIDTH = 8
WHATS = ('train', 'serve')


def _median_ms(fn, reps, device):
    """Median milliseconds of `fn()` over `reps` runs after one warm-up,
    each ended by a device synchronization."""
    fn()
    sync(device)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def _worker(mesh, batch, hidden, reps):
    """One rank: {'train': median ms, 'serve': median ms}."""
    import torch
    import torch.distributed as dist
    from ..models import (fold_eval_params, folded_forward, init_loco_params,
                          loco_forward_train_mesh, n_dropout_sites, params_from_numpy,
                          train_keep_masks)
    from ..parallel.dryrun import _batch, _leaves
    from ..parallel.mesh import all_reduce_data, reduce_loss, row_range
    from ..train.losses import LOSS_TASKS_STEREO, composite_losses, weighted_total

    device = mesh.device
    params, bn_state = params_from_numpy(*init_loco_params(0, 68, 10, hidden, 3), device)
    folded = fold_eval_params(params, bn_state)
    x, y = (torch.from_numpy(a).to(device) for a in _batch(batch))
    lo, hi = row_range(batch, mesh)
    x_local, y_local = x[lo:hi], y[lo:hi]
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(1)
    ones = torch.ones(hi - lo, device=device)
    state = {'bn': bn_state}

    def train_step():
        masks = [m[lo:hi] for m in train_keep_masks(batch, hidden, n_dropout_sites(3), 0.2,
                                                    gen, device)]
        out, state['bn'] = loco_forward_train_mesh(params, state['bn'], x_local, mesh, 0.2,
                                                   masks)
        values = [reduce_loss(v * ((hi - lo) / batch), mesh)
                  for v in composite_losses(out, y_local, LOSS_TASKS_STEREO, phase='train',
                                            mask=ones)]
        loss, _ = weighted_total(values, (1.0,) * len(LOSS_TASKS_STEREO))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh.dp > 1:
            for t in leaves:
                dist.all_reduce(t.grad, group=mesh.data_group)
        optimizer.step()

    def serve():
        with torch.no_grad():
            return float(all_reduce_data(folded_forward(folded, x_local).sum(), mesh))

    return {'train': _median_ms(train_step, reps, device),
            'serve': _median_ms(serve, reps, device)}


def run_width(dp, batch, hidden, reps, disable_cuda):
    """One width in a fresh interpreter: {'train': ms, 'serve': ms}."""
    cmd = [sys.executable, '-m', 'monoloco_tpu_torch.tools.bench_mesh_scaling', '--child',
           str(dp), '--batch', str(batch), '--hidden', str(hidden), '--reps', str(reps)]
    if disable_cuda:
        cmd.append('--disable-cuda')
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    for line in proc.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
    raise RuntimeError(f'dp{dp} failed rc={proc.returncode}\n'
                       f'{proc.stdout[-1000:]}\n{proc.stderr[-2000:]}')


def default_widths(disable_cuda):
    import torch
    n = CPU_WIDTH if disable_cuda else torch.cuda.device_count()
    widths, w = [], 1
    while w <= n:
        widths.append(w)
        w *= 2
    return widths


def verdicts(walls, widths):
    """{what: (ratio of the widest width's wall to dp1's, 'OK' or
    'PATHOLOGICAL')}: the JAX tool's rule at the widest width measured."""
    out = {}
    for what in WHATS:
        ratio = walls[(what, max(widths))] / walls[(what, 1)]
        out[what] = (ratio, 'OK' if ratio <= RATIO_LIMIT else 'PATHOLOGICAL')
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--widths', help='comma-separated dp widths (default: powers of two '
                                         'up to the device count, 8 on the CPU)')
    parser.add_argument('--batch', type=int, default=BATCH)
    parser.add_argument('--hidden', type=int, default=HIDDEN)
    parser.add_argument('--reps', type=int, default=5)
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    parser.add_argument('--child', type=int, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not args.disable_cuda:
        from ..network.engine import default_device
        default_device()
    device_type = 'cpu' if args.disable_cuda else 'cuda'
    if args.child is not None:
        from ..parallel import launch
        rec = launch(_worker, args.child, 1, args=(args.batch, args.hidden, args.reps),
                     device_type=device_type)
        print('RESULT ' + json.dumps(rec), flush=True)
        return rec
    widths = ([int(w) for w in args.widths.split(',')] if args.widths
              else default_widths(args.disable_cuda))
    if 1 not in widths or min(widths) < 1:
        raise SystemExit(f"--widths {widths}: the verdict compares against dp1, which must "
                         f"be among the widths")
    if not args.disable_cuda and max(widths) > torch.cuda.device_count():
        raise SystemExit(f"--widths: dp{max(widths)} requested but only "
                         f"{torch.cuda.device_count()} CUDA devices are available")
    device = device_name(args.disable_cuda)
    walls = {}
    for dp in sorted(set(widths)):
        rec = run_width(dp, args.batch, args.hidden, args.reps, args.disable_cuda)
        for what in WHATS:
            walls[(what, dp)] = rec[what]
            print(json.dumps({'what': what, 'dp': dp, 'batch': args.batch,
                              'hidden': args.hidden, 'median_step_ms': rec[what],
                              'device': device}), flush=True)
    result = verdicts(walls, widths)
    widest = max(widths)
    for what, (ratio, verdict) in result.items():
        print(f'{what}: dp{widest}/dp1 step-wall ratio {ratio:.2f} (fixed total '
              f'batch {args.batch}) -> {verdict}', flush=True)
    if any(v == 'PATHOLOGICAL' for _, v in result.values()):
        sys.exit(1)
    return walls, result


if __name__ == '__main__':
    main()
