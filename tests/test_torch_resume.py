"""`--resume` in the port (`monoloco_tpu_torch.train.Trainer`), on the CPU
at a small size (hidden 64, 2 stages), against itself and the JAX package.

- The port's 2 + 2 epochs equal its straight 4 (weights, BN statistics,
  logs and Adam's moments to 1e-6; on the CPU they are equal bit for bit).
- A zero-epoch resume keeps `best_val_acc`, the meta's `epoch` and the
  serving weights (the JAX package's `tests/test_extras.py:436` case).
- An auto-tune mismatch raises, naming the flag.
- From a JAX-written blob: the JAX Trainer runs 2 epochs and saves (with
  optax's `opt_state`); the port resumes it for 2 more, fed the JAX
  package's permutations and keep-masks for epochs 3-4, and is held to the
  JAX package's straight 4-epoch run within the tolerances of
  tests/test_torch_train.py (the pre-BN biases and BN running means 2 lr a
  step, the other weights 1e-4, train logs 1e-4 and val logs 5e-3
  relative), with Adam's moments equal to optax's right after the load.
- The blob keeps the JAX keys, and the JAX package reads it (and resumes
  it with fresh moments).
"""

import argparse
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.train import Trainer as JaxTrainer
from monoloco_tpu_torch import run
from monoloco_tpu_torch.models import load_train_state
from monoloco_tpu_torch.train import Trainer
from monoloco_tpu_torch.train.trainer import _leaves
from test_torch_train import (LOG_RTOL, PARAM_TOL_EPOCHS, PRE_BN_BIASES, VAL_LOG_RTOL,
                              _get, _leaves_with_paths, _np, jax_keep_masks)

HERE = os.path.dirname(os.path.abspath(__file__))
HIDDEN, STAGES, LR = 64, 2, 0.002
EXACT_TOL = 1e-6


@pytest.fixture(scope='module')
def joints(tmp_path_factory):
    d = tmp_path_factory.mktemp('resume_joints')
    shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-mono.json'), d / 'mono.json')
    return str(d / 'mono.json')


def _args(joints, out, **kw):
    base = dict(joints=joints, mode='mono', out=str(out), epochs=4, bs=128, dropout=0.2,
                lr=LR, sched_step=4, sched_gamma=0.5, hidden_size=HIDDEN, n_stage=STAGES,
                r_seed=3, auto_tune_mtl=False, no_save=False, print_loss=False,
                disable_cuda=True, resume=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _run(args):
    trainer = Trainer(args)
    trainer.train()
    trainer.evaluate()
    return trainer


def _adam(trainer):
    return [trainer.optimizer.state[t] for t in trainer._trainable()]


@pytest.mark.parametrize('auto_tune', [False, True], ids=['fixed', 'auto_tune_mtl'])
def test_resumed_run_equals_a_straight_one(joints, tmp_path, auto_tune):
    straight = _run(_args(joints, tmp_path / 'straight.pkl', auto_tune_mtl=auto_tune))
    _run(_args(joints, tmp_path / 'half.pkl', epochs=2, auto_tune_mtl=auto_tune))
    resumed = _run(_args(joints, tmp_path / 'resumed.pkl', auto_tune_mtl=auto_tune,
                         resume=str(tmp_path / 'half.pkl')))
    assert resumed.start_epoch == 2 and resumed.n_steps == straight.n_steps
    for a, b in zip(_leaves(straight.final_params) + _leaves(straight.final_bn_state),
                    _leaves(resumed.final_params) + _leaves(resumed.final_bn_state)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=EXACT_TOL)
    for a, b in zip(_leaves(straight.params), _leaves(resumed.params)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=EXACT_TOL)
    for sa, sb in zip(_adam(straight), _adam(resumed)):
        assert float(sa['step']) == float(sb['step'])
        for key in ('exp_avg', 'exp_avg_sq'):
            np.testing.assert_allclose(_np(sb[key]), _np(sa[key]), rtol=0, atol=EXACT_TOL)
    for phase in ('train', 'val'):
        for name, values in straight.epoch_losses[phase].items():
            np.testing.assert_allclose(resumed.epoch_losses[phase][name], values[2:],
                                       rtol=EXACT_TOL, atol=EXACT_TOL)
    assert resumed.best_epoch == straight.best_epoch
    assert resumed.best_acc == pytest.approx(straight.best_acc, rel=EXACT_TOL)
    with open(tmp_path / 'resumed.pkl', 'rb') as f:
        blob = pickle.load(f)
    assert blob['meta']['epoch'] == 4 and 'opt_state' not in blob
    state = blob['torch_train_state']
    assert state['n_steps'] == straight.n_steps and state['generator_device'] == 'cpu'
    assert len(state['adam']['exp_avg']) == len(straight._trainable())


def test_zero_epoch_resume_keeps_the_best(joints, tmp_path):
    """The JAX package's `tests/test_extras.py:436` case: resuming with no
    epochs left keeps the best weights, `best_val_acc` and the epoch."""
    first = _run(_args(joints, tmp_path / 'a.pkl', epochs=3))
    again = _run(_args(joints, tmp_path / 'b.pkl', epochs=3, resume=str(tmp_path / 'a.pkl')))
    with open(tmp_path / 'b.pkl', 'rb') as f:
        blob = pickle.load(f)
    assert blob['meta']['epoch'] == 3
    assert blob['meta']['best_val_acc'] == first.best_acc
    assert blob['meta']['best_epoch'] == first.best_epoch
    assert again.epoch_losses == {} or not again.epoch_losses['val']
    for a, b in zip(_leaves(first.params) + _leaves(first.bn_state),
                    _leaves(again.params) + _leaves(again.bn_state)):
        assert torch.equal(a, b)


def test_auto_tune_mismatch_raises(joints, tmp_path):
    _run(_args(joints, tmp_path / 'a.pkl', epochs=1))
    with pytest.raises(ValueError, match='auto_tune_mtl'):
        Trainer(_args(joints, tmp_path / 'b.pkl', auto_tune_mtl=True,
                      resume=str(tmp_path / 'a.pkl')))


def test_blob_without_resume_state_starts_fresh_moments(joints, tmp_path, caplog):
    """A blob with weights only (the reference's, or an older port's): its final
    weights, fresh Adam moments, the schedule from step 0, and a warning."""
    _run(_args(joints, tmp_path / 'a.pkl', epochs=2))
    with open(tmp_path / 'a.pkl', 'rb') as f:
        blob = pickle.load(f)
    del blob['torch_train_state']
    with open(tmp_path / 'weights_only.pkl', 'wb') as f:
        pickle.dump(blob, f)
    with caplog.at_level('WARNING'):
        t = Trainer(_args(joints, tmp_path / 'b.pkl', resume=str(tmp_path / 'weights_only.pkl')))
    assert 'fresh' in caplog.text
    assert t.n_steps == 0 and t.start_epoch == 2 and not t.optimizer.state
    for path, v in _leaves_with_paths(t.params):
        np.testing.assert_array_equal(_np(v), _get(blob['final_params'], path))


def _jax_run(args, epochs):
    """The JAX Trainer for `epochs` (saving at args.out); its per-epoch logs
    are captured from `_print_losses`."""
    trainer = JaxTrainer(argparse.Namespace(**dict(vars(args), epochs=epochs,
                                                   print_loss=True)))
    captured = {}
    trainer._print_losses = captured.update
    trainer.train()
    trainer.evaluate()
    return trainer, captured


def test_resume_of_a_jax_blob_follows_the_jax_run(joints, tmp_path):
    """JAX 2 epochs + port 2 against JAX 4 straight, dropout 0.2, the lr
    halved every 4 steps; the port fed JAX's permutations and keep-masks."""
    args = _args(joints, tmp_path / 'jax_half.pkl', epochs=2)
    j_half, _ = _jax_run(args, 2)
    j_full, j_logs = _jax_run(_args(joints, tmp_path / 'jax_full.pkl'), 4)

    pt = Trainer(_args(joints, tmp_path / 'port.pkl', resume=str(tmp_path / 'jax_half.pkl')))
    assert pt.start_epoch == 2
    # Adam's moments after the load are optax's.
    (opt,) = j_half.opt_state
    assert pt.n_steps == int(opt.count)
    for (path, t), st in zip(_leaves_with_paths(pt.params), _adam(pt)):
        assert float(st['step']) == int(opt.count)
        np.testing.assert_array_equal(_np(st['exp_avg']), np.asarray(_get(opt.mu['model'], path)))
        np.testing.assert_array_equal(_np(st['exp_avg_sq']),
                                      np.asarray(_get(opt.nu['model'], path)))
    n, bs = pt.n_train, pt.bs
    nb = -(-n // bs)

    def jax_perm(epoch):
        perm = jax.random.permutation(jax.random.fold_in(j_full.train_key, epoch), n)
        return torch.from_numpy(np.asarray(perm, np.int64))

    def jax_masks(epoch, step, rows):
        epoch_rng = jax.random.fold_in(j_full.train_key, epoch)
        rng = jax.random.split(jax.random.fold_in(epoch_rng, 1), nb)[step]
        return [m[:rows] for m in jax_keep_masks(rng, bs, HIDDEN, 0.2, STAGES)]

    pt._permutation = jax_perm
    pt._step_masks = jax_masks
    pt.train()
    pt.evaluate()
    for phase, rtol in (('train', LOG_RTOL), ('val', VAL_LOG_RTOL)):
        for name in ['all'] + list(pt.tasks):
            np.testing.assert_allclose(pt.epoch_losses[phase][name], j_logs[phase][name][2:],
                                       rtol=rtol, err_msg=f'{phase} {name}')
    steps = 2 * nb
    assert pt.n_steps == 4 * nb
    for path, v in _leaves_with_paths(pt.final_params):
        err = np.abs(_np(v) - np.asarray(_get(j_full.final_params, path))).max()
        bound = 2 * LR * steps if path in PRE_BN_BIASES else PARAM_TOL_EPOCHS
        assert err <= bound, (path, err)
    for path, v in _leaves_with_paths(pt.final_bn_state):
        err = np.abs(_np(v) - np.asarray(_get(j_full.final_bn_state, path))).max()
        assert err <= (2 * LR * steps if path[-1] == 'mean' else PARAM_TOL_EPOCHS), (path, err)
    assert pt.best_epoch == j_full.best_epoch


def test_port_blob_keeps_the_jax_keys_and_resumes_in_jax(joints, tmp_path):
    """The port's checkpoint has the JAX blob's keys (and 'torch_train_state'
    instead of 'opt_state'); the JAX Trainer resumes it with fresh moments
    from the port's final weights."""
    pt = _run(_args(joints, tmp_path / 'port.pkl', epochs=2))
    blob = load_train_state(str(tmp_path / 'port.pkl'))
    assert set(blob) == {'format', 'params', 'bn_state', 'final_params', 'final_bn_state',
                         'log_sigmas', 'meta', 'torch_train_state'}
    jt = JaxTrainer(_args(joints, tmp_path / 'jax.pkl', epochs=3,
                          resume=str(tmp_path / 'port.pkl')))
    assert jt.start_epoch == 2 and int(jt.opt_state[0].count) == 0
    for path, v in _leaves_with_paths(pt.final_params):
        np.testing.assert_array_equal(np.asarray(_get(jt.params, path)), _np(v))
    jt.train()
    assert jt.last_epoch == 2


def test_cli_resume_and_orbax_refusal(joints, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ['train', '--joints', joints, '--hidden_size', '32', '--n_stage', '1', '--bs', '128',
            '--disable-cuda']
    run.main(base + ['--epochs', '1', '--out', 'a.pkl'])
    trainer = run.main(base + ['--epochs', '2', '--out', 'b.pkl', '--resume', 'a.pkl'])
    assert trainer.start_epoch == 1 and len(trainer.epoch_losses['val']['d']) == 1
    for flag in ('--resume', '--out'):
        with pytest.raises(SystemExit, match='imports jax'):
            run.main(base + [flag, 'x.orbax'])
