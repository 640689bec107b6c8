"""HypTuning in the port (`monoloco_tpu_torch.train.hyp_tuning`) against the
JAX package's, on the CPU.

- The trial list (shuffled grids and log-uniform lrs) equals the JAX
  package's for r_seed 1 and 7 at multiplier 1 and 2: both draw it from
  `random` and `np.random` alone.
- Each serial trial's Trainer gets the JAX package's arguments (recorded
  through a stand-in Trainer in both packages), and with the same trial
  results both write the same winner, pickle keys and log JSON.
- The stacked executor (MONOLOCO_TPU_HYP_PARALLEL=1) against the serial one
  at hidden 64, 2 stages: the same winner and best epoch, and `acc_val`
  within rel 2e-4 (the JAX package's `tests/test_hyp_parallel.py:40` bound;
  on the CPU the two are equal bit for bit); every trial of mixed groups
  (a stacked pair and a singleton) against its serial run.
- `run train --hyp` with the JAX flags.
"""

import argparse
import glob
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from monoloco_tpu.train import hyp_tuning as jax_hyp
from monoloco_tpu_torch import run
from monoloco_tpu_torch.train import hyp_tuning

HERE = os.path.dirname(os.path.abspath(__file__))
ACC_RTOL = 2e-4


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-mono.json'), tmp_path / 'mono.json')
    monkeypatch.chdir(tmp_path)
    for d in ('data/models', 'data/logs', 'data/outputs'):
        os.makedirs(d, exist_ok=True)
    return tmp_path


def _args(**kw):
    base = dict(joints='mono.json', mode='mono', out=None, epochs=2, bs=256, dropout=0.2,
                lr=0.002, sched_step=30, sched_gamma=0.98, hidden_size=64, n_stage=2,
                r_seed=1, auto_tune_mtl=False, no_save=True, print_loss=False,
                disable_cuda=True, resume=None, profile=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize('r_seed', [1, 7])
@pytest.mark.parametrize('multiplier', [1, 2])
def test_trial_list_equals_jax(workdir, r_seed, multiplier):
    port = hyp_tuning.HypTuning('mono.json', 3, monocular=True, multiplier=multiplier,
                                r_seed=r_seed)
    ref = jax_hyp.HypTuning('mono.json', 3, monocular=True, multiplier=multiplier,
                            r_seed=r_seed)
    assert port._trial_combos() == ref._trial_combos()
    assert len(port._trial_combos()) == 6 * multiplier
    assert port.path_model == ref.path_model and port.path_log == ref.path_log


class _Recorder:
    """A stand-in Trainer: records its arguments, trains nothing, and
    reports a val 'd' error from a fixed table, per trial."""

    calls = []
    accs = (9.5, 7.25, 30.0, 7.25, 8.0, 12.0)

    def __init__(self, args):
        self.args = dict(vars(args))
        _Recorder.calls.append(self.args)
        self.idx = len(_Recorder.calls) - 1

    def train(self):
        return self.idx % 3

    def evaluate(self):
        acc = _Recorder.accs[self.idx % len(_Recorder.accs)]
        model = ({'w': np.full(2, float(self.idx), np.float32)},
                 {'m': np.zeros(1, np.float32)})
        return {'val': {'all': {'d': acc}}}, model


def _run_recorded(module, monkeypatch, args):
    _Recorder.calls = []
    monkeypatch.setattr(module, 'Trainer', _Recorder)
    hyp = module.HypTuning('mono.json', args.epochs, monocular=True, multiplier=1, r_seed=5)
    best = hyp.train(args)
    with open(hyp.path_model, 'rb') as f:
        blob = pickle.load(f)
    with open(glob.glob(hyp.path_log + '*')[-1]) as f:
        log = json.load(f)
    for path in glob.glob('data/models/*') + glob.glob('data/logs/*'):
        os.remove(path)
    return list(_Recorder.calls), best, blob, log


def test_serial_trials_get_the_jax_arguments_and_write_the_jax_files(workdir, monkeypatch):
    monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', '0')
    args = _args()
    calls, best, blob, log = _run_recorded(hyp_tuning, monkeypatch, args)
    j_calls, j_best, j_blob, j_log = _run_recorded(jax_hyp, monkeypatch, args)
    assert calls == j_calls and len(calls) == 6
    assert all(c['no_save'] for c in calls)
    assert best == j_best and log == j_log == best
    assert best['acc_val'] == 7.25 and best['best_epoch'] == 1      # the first of the tie
    assert set(blob) == set(j_blob) == {'format', 'params', 'bn_state', 'meta'}
    assert blob['meta'] == j_blob['meta']
    np.testing.assert_array_equal(blob['params']['w'], j_blob['params']['w'])


def test_no_trial_under_the_threshold_keeps_the_last(workdir, monkeypatch):
    monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', '0')
    monkeypatch.setattr(_Recorder, 'accs', (25.0,) * 6)
    _, best, blob, _ = _run_recorded(hyp_tuning, monkeypatch, _args())
    _, j_best, j_blob, _ = _run_recorded(jax_hyp, monkeypatch, _args())
    assert best == j_best and best['note'] == 'no trial under threshold'
    np.testing.assert_array_equal(blob['params']['w'], j_blob['params']['w'])


def _shrunk(hidden=None, r_seed=1):
    hyp = hyp_tuning.HypTuning('mono.json', 2, monocular=True, dropout=0.2, multiplier=1,
                               r_seed=r_seed)
    hyp.hidden_list = list(hidden or [64] * 6)
    hyp.bs_list = [128] * 6
    hyp.n_stage_list = [2] * 6
    hyp.lr_list = hyp.lr_list[:3]
    return hyp


def test_stacked_matches_serial(workdir, monkeypatch):
    """The JAX package's `test_parallel_matches_serial`, in the port."""
    results = {}
    for flag in ('0', '1'):
        monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', flag)
        hyp = _shrunk()
        results[flag] = (hyp.train(_args()), hyp.trial_results)
    (serial, s_trials), (stacked, p_trials) = results['0'], results['1']
    for key in ('lr', 'bs', 'sched_gamma', 'sched_step', 'hidden_size', 'n_stage',
                'best_epoch'):
        assert stacked[key] == serial[key], key
    assert stacked['acc_val'] == pytest.approx(serial['acc_val'], rel=ACC_RTOL)
    for (a, ea), (b, eb) in zip(s_trials, p_trials):
        assert eb == ea and b == pytest.approx(a, rel=ACC_RTOL)
    assert len(hyp_tuning.HypTuning.groups(hyp)) == 1


def test_mixed_groups_cover_all_trials(workdir, monkeypatch):
    """A stacked pair at hidden 64 and a singleton at hidden 32 (the plain
    Trainer): every trial against its serial run, and the winner is the
    argmin over both groups."""
    hidden = [64, 32, 64, 32, 64, 32]
    results = {}
    for flag in ('0', '1'):
        monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', flag)
        hyp = _shrunk(hidden)
        results[flag] = (hyp.train(_args()), hyp.trial_results)
    assert list(hyp.groups().values()) == [[0, 2], [1]]
    (serial, s_trials), (stacked, p_trials) = results['0'], results['1']
    assert len(p_trials) == 3
    for (a, ea), (b, eb) in zip(s_trials, p_trials):
        assert eb == ea and b == pytest.approx(a, rel=ACC_RTOL)
    assert stacked['hidden_size'] == serial['hidden_size'] in (32, 64)
    assert stacked['acc_val'] == min(r[0] for r in p_trials)
    assert 0 < stacked['acc_val'] < 20


def test_stacked_auto_tune_matches_serial(workdir, monkeypatch):
    """With the loss's log-sigmas trained beside the model."""
    results = {}
    for flag in ('0', '1'):
        monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', flag)
        hyp = _shrunk()
        hyp.lr_list = hyp.lr_list[:2]
        results[flag] = hyp.train(_args(auto_tune_mtl=True))
    assert results['1']['acc_val'] == pytest.approx(results['0']['acc_val'], rel=ACC_RTOL)
    assert results['1']['best_epoch'] == results['0']['best_epoch']


def test_cli_hyp(workdir, monkeypatch):
    """`run train --hyp` with the JAX flags, at a shrunk search space."""
    real_init = hyp_tuning.HypTuning.__init__
    seen = {}

    def shrink(self, *args, **kw):
        real_init(self, *args, **kw)
        seen.update(kw)
        self.hidden_list = [32] * len(self.hidden_list)
        self.bs_list = [256] * len(self.bs_list)
        self.lr_list = self.lr_list[:2]

    monkeypatch.setattr(hyp_tuning.HypTuning, '__init__', shrink)
    monkeypatch.setenv('MONOLOCO_TPU_HYP_PARALLEL', '1')
    best = run.main(['train', '--joints', 'mono.json', '--hyp', '--multiplier', '2',
                     '--r_seed', '7', '--monocular', '--epochs', '1', '--n_stage', '1',
                     '--disable-cuda'])
    assert seen == {'joints': 'mono.json', 'epochs': 1, 'monocular': True, 'dropout': 0.2,
                    'multiplier': 2, 'r_seed': 7}
    assert best['random_seed'] == 7 and best['monocular'] is True
    assert glob.glob('data/models/hyp-monoloco-*.pkl') and glob.glob('data/logs/hyp-monoloco-*')
