"""The hyperparameter search's executors, timed on one CUDA card.

Counterpart of the JAX package's `tools/bench_hyp_search.py`:

    python -m monoloco_tpu_torch.tools.bench_hyp_search e2e serial [--disable-cuda]
    python -m monoloco_tpu_torch.tools.bench_hyp_search e2e parallel [--disable-cuda]
    python -m monoloco_tpu_torch.tools.bench_hyp_search core [--disable-cuda]

`e2e` runs the whole HypTuning search (`train/hyp_tuning.py`: the default
space, 6 trials, 150 epochs a trial, on the fixture
`tests/fixture_joints-kitti-mono.json`) under one executor: `serial` (a
Trainer a trial) or `parallel` (MONOLOCO_TPU_HYP_PARALLEL=1: each (bs,
hidden, n_stage) group trained as one stacked model). `core` isolates the
training loop: the same 24 trials (lr only, log-uniform in [5e-4, 1e-2]
from numpy seed 0; bs 512, hidden 1024, 3 stages, gamma 0.98, step 30)
once as one stacked 24-model `StackedTrials` and once one after another on
one Trainer, each from the same initial weights and generator seed; each
executor runs once to warm up, then once timed, as the JAX tool does. Its
line keeps the JAX tool's keys: `vmapped_24trials` names the stacked
executor here, as vmap was the JAX tool's.

Each prints the JAX tool's text line, then one JSON line. The search writes
its model and log under `data/` of a temporary working directory, removed
afterwards. Without a card and without `--disable-cuda` it raises
(`default_device()`).
"""

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np

from . import device_name, sync
from .bench_cli_phases import train_args

EPOCHS = 150
CORE_TRIALS = 24


def search_args(epochs=EPOCHS, hidden_size=1024, disable_cuda=False):
    """The JAX tool's Trainer arguments: `tools.bench_cli_phases`'s, saving
    nothing."""
    return train_args(None, hidden_size, epochs, disable_cuda, no_save=True)


@contextlib.contextmanager
def _workdir():
    """A temporary working directory for the search's `data/` files."""
    old = os.getcwd()
    with tempfile.TemporaryDirectory(prefix='hyp_search_') as tmp:
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(old)


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def run_e2e(executor, epochs=EPOCHS, disable_cuda=False):
    """The whole search under `executor` ('serial' or 'parallel'); returns
    its record."""
    from ..train import HypTuning
    args = search_args(epochs, disable_cuda=disable_cuda)
    with _workdir(), _env('MONOLOCO_TPU_HYP_PARALLEL', '1' if executor == 'parallel' else '0'):
        hyp = HypTuning(joints=args.joints, epochs=epochs, monocular=True, dropout=0.2,
                        multiplier=1, r_seed=1)
        t0 = time.perf_counter()
        best = hyp.train(args)
        wall = time.perf_counter() - t0
    print(f"HYP e2e {executor}: wall={wall:.1f}s best_lr={best.get('lr')} "
          f"acc={best.get('acc_val')}", flush=True)
    return {'metric': 'hyp_search_e2e', 'executor': executor, 'wall_s': wall,
            'trials': len(hyp.trial_results), 'epochs': epochs, 'best_lr': best.get('lr'),
            'acc_val': best.get('acc_val'), 'device': device_name(disable_cuda)}


def core_lrs(n=CORE_TRIALS):
    rng = np.random.RandomState(0)
    return 10 ** rng.uniform(np.log10(5e-4), np.log10(1e-2), n)


def run_core(epochs=EPOCHS, hidden_size=1024, disable_cuda=False):
    """The 24 lr-only trials stacked, then serial (each warmed up once, then
    timed); returns the record."""
    from ..models.loco import _tree_clone
    from ..train import Trainer
    from ..train.hyp_tuning import StackedTrials
    t = Trainer(search_args(epochs, hidden_size, disable_cuda))
    params0, bn0 = _tree_clone(t.params), _tree_clone(t.bn_state)
    lrs = core_lrs()
    combos = [dict(lr=float(lr), sched_gamma=0.98, sched_step=30) for lr in lrs]

    def restart(lr=None):
        t.set_weights(params0, bn0)
        t.gen.manual_seed(t.r_seed)
        t.start_epoch, t._resume_best = 0, None
        if lr is not None:
            t.lr = lr

    def run_stacked():
        restart()
        results = StackedTrials(t, combos).train(epochs)
        return np.array([acc for acc, _, _, _ in results])

    def run_serial():
        accs = []
        for lr in lrs:
            restart(float(lr))
            t.train()
            accs.append(float(t.best_acc))
        return np.array(accs)

    walls = {}
    for name, fn in (('stacked', run_stacked), ('serial', run_serial)):
        fn()                                  # warm-up
        sync(t.device)
        t0 = time.perf_counter()
        accs = fn()
        sync(t.device)
        walls[name] = (time.perf_counter() - t0, accs)
    tv, av = walls['stacked']
    ts, asr = walls['serial']
    winner_same = bool(np.argmin(av) == np.argmin(asr))
    print(f"HYP core: vmapped_24trials={tv:.1f}s serial_24trials={ts:.1f}s "
          f"ratio_serial_over_vmapped={ts / tv:.2f} winner_same={winner_same}", flush=True)
    return {'metric': 'hyp_search_core', 'vmapped_24trials': tv, 'serial_24trials': ts,
            'ratio_serial_over_vmapped': ts / tv, 'winner_same': winner_same,
            'trials': len(lrs), 'epochs': epochs, 'hidden_size': hidden_size,
            'device': device_name(disable_cuda)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('what', choices=('e2e', 'core'))
    parser.add_argument('executor', nargs='?', choices=('serial', 'parallel'),
                        help='e2e: the executor')
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    args = parser.parse_args(argv)
    if args.what == 'e2e' and args.executor is None:
        parser.error("e2e needs an executor: serial or parallel")
    if not args.disable_cuda:
        from ..network.engine import default_device
        default_device()
    if args.what == 'core':
        record = run_core(disable_cuda=args.disable_cuda)
    else:
        record = run_e2e(args.executor, disable_cuda=args.disable_cuda)
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
