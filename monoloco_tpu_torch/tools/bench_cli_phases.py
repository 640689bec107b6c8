"""Per-phase walls of the train CLI path on one CUDA card.

Counterpart of the JAX package's `tools/bench_cli_phases.py`, at its
configuration: the fixture `tests/fixture_joints-kitti-mono.json`, mono,
hidden 256, 3 stages, 5 epochs, bs 512, dropout 0.2, lr 0.002, sched_step
30, gamma 0.98, r_seed 1. Phases: imports (torch and the port's Trainer;
near 0 when the calling process has loaded them already) -> Trainer
construction (the dataset to the device, the init, Adam) -> train() (the
epochs, each ending in one fetch of its logs) -> evaluate() (one forward
over the val set and its clusters, one fetch, and the checkpoint written).
The JAX tool's compile-cache variants have no counterpart: the port
compiles no XLA program (`utils/compile_cache.py` is not ported).

    python -m monoloco_tpu_torch.tools.bench_cli_phases [--out CKPT] [--disable-cuda]

Prints the JAX tool's four lines (`imports: x s`, `Trainer init: x s`,
`train: x s`, `evaluate: x s`), then the walls on one JSON line. The
checkpoint goes to `--out`, else into a temporary directory that is
removed. Without a card and without `--disable-cuda` it raises
(`default_device()`).
"""

import argparse
import json
import os
import tempfile
import time

from . import REPO, device_name, sync

JOINTS = os.path.join(REPO, 'tests', 'fixture_joints-kitti-mono.json')


def train_args(out, hidden_size=256, epochs=5, disable_cuda=False, no_save=False):
    """The JAX tool's Trainer arguments (those of `tools/bench_hyp_search.py`
    too, which saves nothing)."""
    return argparse.Namespace(
        joints=JOINTS, mode='mono', out=out, epochs=epochs, bs=512, dropout=0.2,
        lr=0.002, sched_step=30, sched_gamma=0.98, hidden_size=hidden_size, n_stage=3,
        r_seed=1, auto_tune_mtl=False, no_save=no_save, print_loss=False,
        disable_cuda=disable_cuda)


def phases(out, hidden_size=256, epochs=5, disable_cuda=False):
    """The four walls (seconds), printed as the JAX tool prints them, and the
    device, as a dict."""
    t0 = time.perf_counter()
    import torch  # noqa: F401  (timed: the imports phase)
    from ..train import Trainer
    walls = {'imports_s': time.perf_counter() - t0}
    print(f"imports: {walls['imports_s']:.1f} s", flush=True)
    if not disable_cuda:
        from ..network.engine import default_device
        default_device()
    args = train_args(out, hidden_size, epochs, disable_cuda)
    t = time.perf_counter()
    trainer = Trainer(args)
    sync(trainer.device)
    walls['trainer_init_s'] = time.perf_counter() - t
    print(f"Trainer init: {walls['trainer_init_s']:.1f} s", flush=True)
    t = time.perf_counter()
    trainer.train()
    sync(trainer.device)
    walls['train_s'] = time.perf_counter() - t
    print(f"train: {walls['train_s']:.1f} s", flush=True)
    t = time.perf_counter()
    trainer.evaluate()
    sync(trainer.device)
    walls['evaluate_s'] = time.perf_counter() - t
    print(f"evaluate: {walls['evaluate_s']:.1f} s", flush=True)
    return {'metric': 'cli_phases', **walls, 'hidden_size': hidden_size, 'epochs': epochs,
            'train_rows': trainer.n_train, 'best_epoch': trainer.best_epoch,
            'device': device_name(disable_cuda)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', help='the checkpoint (default: a temporary file, removed)')
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    args = parser.parse_args(argv)
    if args.out:
        record = phases(os.path.abspath(args.out), disable_cuda=args.disable_cuda)
    else:
        with tempfile.TemporaryDirectory(prefix='cli_phases_') as tmp:
            record = phases(os.path.join(tmp, 'bench_cli_phases.pkl'),
                            disable_cuda=args.disable_cuda)
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
