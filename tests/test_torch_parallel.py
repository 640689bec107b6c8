"""Device meshes of the port (`monoloco_tpu_torch/parallel/`) on the CPU: gloo
process groups of spawned ranks, against the port's own single-device runs
and the JAX package's (`tests/test_parallel.py`).

- The tensor-parallel specs equal the JAX package's, and the shards have
  the shapes of `tests/test_parallel.py:176-195`.
- Training: a dp2 and a dp2 x tp2 Trainer against one device. The step
  computes what one device computes (global BN statistics, global loss,
  summed gradients, the global clip norm), but the biases that feed a BN
  have gradients that are zero in exact arithmetic and rounding in floats,
  which Adam divides by |g| + 1e-8 (tests/test_torch_train.py): any other
  order of the sums moves them by a sizeable fraction of lr a step, and
  the val losses (BN's running means follow them) part by about 1e-3 after
  two epochs, by an amount that depends on the CPU's sum orders. So with
  those gradients zeroed in both runs (`torch_mesh_workers`), dp2 is held
  to rtol 1e-5 after two epochs with dropout 0.2 (every rank draws the
  global batch's keep-masks and keeps its rows) and dp2 x tp2 to rtol
  1e-4; as they are, dp2 is held, against one device and against the JAX
  single-device step (dropout 0, the JAX init), to one step from a shared
  state by the one-step rules of tests/test_torch_train.py (loss 1.5e-5,
  gradients 1e-5 of their global norm, weights that feed no BN 1e-5, the
  pre-BN biases 2 lr, the pre-BN weights 1e-5 plus what Adam's first step
  makes of their gradients' gap), and the free-running gaps are printed.
- GenerateKitti over dp2 writes txts byte-equal to one device's, mono and
  stereo; `serve --dp_devices 2` answers what one device computes;
  `dryrun_multichip(4)` (toy) runs dp2 x tp2.

Every launch has a timeout, so a hung rank fails its test.
"""

import argparse
import json
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.models import save_checkpoint as jax_save
from monoloco_tpu.parallel import loco_param_specs as jax_specs
from monoloco_tpu.train import Trainer as JaxTrainer
from monoloco_tpu_torch import run
from monoloco_tpu_torch.models import init_loco_params, n_dropout_sites, train_keep_masks
from monoloco_tpu_torch.network import Loco
from monoloco_tpu_torch.parallel import launch, loco_param_specs, shard_by_specs
from monoloco_tpu_torch.parallel.dryrun import dryrun_multichip
from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset
from monoloco_tpu_torch.train import Trainer
from monoloco_tpu_torch.train.trainer import ADAM_EPS, GRAD_CLIP
import torch_mesh_workers
from test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_TOL, _get, _jax_step

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 120              # seconds, every launch and subprocess
DP_RTOL = 1e-5             # dp2, pre-BN bias gradients zeroed
TP_RTOL = 1e-4             # dp2 x tp2, pre-BN bias gradients zeroed
JAX_RTOL, JAX_ATOL = 2e-3, 1e-3     # tests/test_parallel.py (printed, no longer held)
STEP_ROWS = 77             # one step's batch: 39 + 38 rows over dp2
SERVE_TOL = 1e-5           # (1 + |ref|)
LR = 0.002


def _train_args(joints, **kw):
    base = dict(joints=str(joints), mode='mono', out=None, epochs=2, bs=64, dropout=0.2,
                lr=LR, sched_step=30, sched_gamma=0.98, hidden_size=64, n_stage=2, r_seed=1,
                auto_tune_mtl=False, no_save=True, print_loss=False, disable_cuda=True)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope='module')
def joints(tmp_path_factory):
    d = tmp_path_factory.mktemp('joints')
    shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-mono.json'), d / 'mono.json')
    return d / 'mono.json'


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_param_specs_match_jax():
    ours = loco_param_specs()
    ref = jax.tree_util.tree_map(_as_tuples, jax_specs(),
                                 is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert ours == tuple(ref)


def test_shard_shapes_match_the_jax_layout():
    """tests/test_parallel.py:176-195 on a 4 x 2 mesh: this rank's slices."""
    params, bn = init_loco_params(0, 34, 9, 64, 3)
    p_spec, bn_spec = loco_param_specs()
    for model_rank in (0, 1):
        mesh = types.SimpleNamespace(tp=2, model_rank=model_rank)
        sp, sb = shard_by_specs(params, mesh, p_spec), shard_by_specs(bn, mesh, bn_spec)
        assert tuple(sp['w1']['w'].shape) == (34, 32)
        assert tuple(sp['w2']['w'].shape) == (32, 64)
        assert tuple(sp['stages']['w2']['w'].shape) == (3, 64, 32)
        assert tuple(sb['bn1']['mean'].shape) == (32,)
        cols = slice(32 * model_rank, 32 * (model_rank + 1))
        assert torch.equal(sp['w1']['w'], params['w1']['w'][:, cols])
        assert torch.equal(sp['w_aux']['w'], params['w_aux']['w'])


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _step_batch(joints, dropout):
    """The first STEP_ROWS training rows and, with dropout, their keep-masks
    from a seeded generator."""
    args = _train_args(joints, dropout=dropout)
    x, y = Trainer(args).datasets['train'].arrays()
    masks = None
    if dropout:
        masks = train_keep_masks(STEP_ROWS, args.hidden_size, n_dropout_sites(args.n_stage),
                                 dropout, torch.Generator().manual_seed(0), 'cpu')
    return x[:STEP_ROWS], y[:STEP_ROWS], masks


def _clipped(step, path):
    return step['grads'][path] * min(1.0, GRAD_CLIP / (step['gnorm'] + 1e-6))


def _assert_step_close(ours, ref):
    """The one-step rules of tests/test_torch_train.py: loss LOSS_TOL, the
    gradients' norm and each gradient before clipping within GRAD_TOL of
    that norm; after the step, the weights that feed no BN within
    PARAM_TOL and the biases that feed one (whose gradients are rounding
    noise) within 2 lr. The weights that feed a BN get PARAM_TOL plus what
    Adam's first step, u = g / (|g| + eps), makes of the two clipped
    gradients' gap: at most lr eps |g - g'| / (m + eps)^2, m the smaller
    |g| (0 if the signs differ), and never more than 2 lr. An entry whose
    activations hardly vary over the batch has a gradient that BN all but
    cancels, as it cancels the biases', and there a gap far inside the
    gradient rule moves the weight by up to 1e-5."""
    np.testing.assert_allclose(ours['loss'], ref['loss'], rtol=LOSS_TOL)
    np.testing.assert_allclose(ours['gnorm'], ref['gnorm'], rtol=GRAD_TOL)
    assert sorted(ours['grads']) == sorted(ref['grads'])
    for path, g in ref['grads'].items():
        err = np.abs(ours['grads'][path] - g).max()
        assert err <= GRAD_TOL * ref['gnorm'], (path, err, ref['gnorm'])
    for path, w in ref['params'].items():
        err = np.abs(ours['params'][path] - w)
        layer = path[:-1]
        if layer not in torch_mesh_workers.PRE_BN_BIASES:
            tol = PARAM_TOL
        elif path[-1] == 'b':
            tol = 2 * LR
        else:
            g, g_ref = _clipped(ours, path), _clipped(ref, path)
            m = np.where(np.sign(g) == np.sign(g_ref), np.minimum(np.abs(g), np.abs(g_ref)), 0.0)
            tol = PARAM_TOL + LR * np.minimum(2.0, ADAM_EPS * np.abs(g - g_ref)
                                              / (m + ADAM_EPS) ** 2)
        assert np.all(err <= tol), (path, err.max())


def _dp2_step(joints, dropout=0.2, **kw):
    """(one device's step, dp2's step) from the trainer's init on the same
    batch and keep-masks."""
    x, y, masks = _step_batch(joints, dropout)
    args = _train_args(joints, dropout=dropout)
    single = torch_mesh_workers.step(None, args, x, y, masks=masks)
    dp = launch(torch_mesh_workers.step, 2, 1, args=(_train_args(joints, dropout=dropout), x, y),
                kwargs={'masks': masks, **kw}, device_type='cpu', timeout=TIMEOUT)
    return single, dp


def test_dp2_trainer_matches_single_device(joints):
    """Dropout 0.2, 2 epochs of 5 batches (the last of 4 rows) with the
    pre-BN bias gradients zeroed; with them live, one step of 77 rows from
    the same state."""
    single = torch_mesh_workers.train(None, _train_args(joints), zero_pre_bn=True)
    dp = launch(torch_mesh_workers.train, 2, 1, args=(_train_args(joints),),
                kwargs={'zero_pre_bn': True}, device_type='cpu', timeout=TIMEOUT)
    print('dp2 vs single, pre-BN bias gradients zeroed: max rel',
          _max_rel(dp['val'], single['val']))
    np.testing.assert_allclose(dp['val'], single['val'], rtol=DP_RTOL)
    assert dp['n_steps'] == single['n_steps'] == 10
    _assert_step_close(*reversed(_dp2_step(joints)))
    single = torch_mesh_workers.train(None, _train_args(joints))
    dp = launch(torch_mesh_workers.train, 2, 1, args=(_train_args(joints),), device_type='cpu',
                timeout=TIMEOUT)
    print('dp2 vs single, free-running, not held: max rel', _max_rel(dp['val'], single['val']))


@pytest.mark.parametrize('fault', ['no_all_reduce'])
def test_dp2_step_check_catches_faults(joints, fault):
    """The step check fails a dp2 step whose gradients are not all-reduced
    over the data ranks."""
    single, dp = _dp2_step(joints, all_reduce=False)
    with pytest.raises(AssertionError):
        _assert_step_close(dp, single)


def test_dp2_trainer_matches_the_jax_single_device_trainer(joints):
    """The JAX test's run (dropout 0, bs 64, hidden 64, 2 stages): one dp2
    step from the JAX init against the JAX Trainer's step on the same 77
    rows; then the JAX Trainer's 2 epochs against the port's dp2 Trainer
    from the JAX init with the JAX epoch orders, the gap printed."""
    args = _train_args(joints, dropout=0.0)
    jt = JaxTrainer(args)
    init = jax.tree_util.tree_map(np.asarray, (jt.params, jt.bn_state))
    x, y, _ = _step_batch(joints, 0.0)
    loss, grads, gnorm, _, new = _jax_step(jt, jt.params, jt.bn_state, x, y,
                                           jax.random.PRNGKey(0), 0.0)
    paths = [p for p, _ in torch_mesh_workers._leaves_with_paths(init[0])]
    ref = {'loss': loss, 'gnorm': gnorm,
           'grads': {p: np.asarray(_get(grads, p)) for p in paths},
           'params': {p: np.asarray(_get(new, p)) for p in paths}}
    dp = launch(torch_mesh_workers.step, 2, 1, args=(_train_args(joints, dropout=0.0), x, y),
                kwargs={'init': init}, device_type='cpu', timeout=TIMEOUT)
    _assert_step_close(dp, ref)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(jt.train_key, e), jt.n_train))
             for e in range(args.epochs)]
    jt.train()
    ref = np.asarray(jt._val_metrics(jt.params, jt.log_sigmas, jt.bn_state, jt.x_va, jt.y_va))
    dp = launch(torch_mesh_workers.train, 2, 1, args=(_train_args(joints, dropout=0.0),),
                kwargs={'init': init, 'perms': perms}, device_type='cpu', timeout=TIMEOUT)
    print('dp2 vs the JAX single device, free-running, not held: max rel',
          _max_rel(dp['val'], ref), 'of the old bound',
          float(np.max(np.abs(dp['val'] - ref) / (JAX_ATOL + JAX_RTOL * np.abs(ref)))))


def test_dp2_tp2_trainer_matches_single_device(joints):
    """Four ranks: Megatron's shards over the model axis, rows over data."""
    single = torch_mesh_workers.train(None, _train_args(joints), zero_pre_bn=True)
    mesh_run = launch(torch_mesh_workers.train, 2, 2, args=(_train_args(joints),),
                      kwargs={'zero_pre_bn': True}, device_type='cpu', timeout=TIMEOUT)
    print('dp2xtp2 vs single, pre-BN bias gradients zeroed: max rel',
          _max_rel(mesh_run['val'], single['val']))
    np.testing.assert_allclose(mesh_run['val'], single['val'], rtol=TP_RTOL)
    assert mesh_run['best_epoch'] == single['best_epoch']


def test_cli_train_on_a_mesh_saves_one_checkpoint(joints, tmp_path):
    """`run train --dp_devices 2 --tp_devices 2`: rank 0 writes the pickle
    from the gathered weights, which serves like any other checkpoint."""
    out = tmp_path / 'mesh.pkl'
    trainer = run.main(['train', '--joints', str(joints), '--epochs', '1', '--hidden_size', '64',
                        '--n_stage', '2', '--out', str(out), '--dp_devices', '2',
                        '--tp_devices', '2', '--disable-cuda'])
    assert trainer.mesh.dp == trainer.mesh.tp == 2 and trainer.main
    assert sorted(os.listdir(tmp_path)) == ['mesh.pkl', 'mesh.txt']
    net = Loco(str(out), device='cpu')
    assert net.linear_size == 64 and net.n_stage == 2


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match='rank 1:'):
        launch(torch_mesh_workers.fail_on_rank_1, 2, 1, device_type='cpu', timeout=30)


def test_a_mesh_on_the_card_needs_its_cards(monkeypatch):
    """No fallback to fewer ranks, gloo or the CPU: the JAX CLI's message."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(SystemExit, match='--dp_devices 2 x --tp_devices 1 requested but only 1 '
                                         'devices are available'):
        launch(torch_mesh_workers.fail_on_rank_1, 2, 1, device_type='cuda')


# ---------------------------------------------------------------------------
# GenerateKitti, serve, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_generate_over_dp2_is_byte_equal(mode, tmp_path, monkeypatch):
    """`eval --generate --dp_devices 2` against the run without a mesh."""
    make_dataset(str(tmp_path), n_train=4, n_val=5, seed=17, images=False)
    monkeypatch.chdir(tmp_path)
    in_dim, out_dim = (68, 10) if mode == 'stereo' else (34, 9)
    params, bn = jax_init(jax.random.PRNGKey(2), in_dim, out_dim, 64, 2)
    params = jax.tree_util.tree_map(np.array, params)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    jax_save('data/outputs/mesh_gen.pkl', params, bn, meta={})
    net = 'monstereo' if mode == 'stereo' else 'monoloco_pp'
    argv = ['eval', '--generate', '--mode', mode, '--dir_ann', 'annotations', '--model',
            'data/outputs/mesh_gen.pkl', '--hidden_size', '64', '--n_stage', '2',
            '--disable-cuda']
    trees = {}
    for key, extra in (('single', []), ('dp2', ['--dp_devices', '2'])):
        gen, _ = run.main(argv + extra)
        trees[key] = {}
        for name in sorted(os.listdir(os.path.join('data', 'kitti', net))):
            with open(os.path.join('data', 'kitti', net, name), 'rb') as f:
                trees[key][name] = f.read()
    assert gen.model.mesh.dp == 2 and gen.model.n_dispatches == 1
    assert trees['dp2'] == trees['single'] and len(trees['single']) == 5


def _post(port, payload):
    req = urllib.request.Request(f'http://127.0.0.1:{port}/v1/predict',
                                 data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def test_serve_over_dp2_answers_what_one_device_computes(tmp_path):
    """`python -m monoloco_tpu_torch.serve --dp_devices 2 --disable-cuda`:
    rank 0 listens; each response equals the single-device engine's
    `forward_batch` of the request."""
    params, bn = jax_init(jax.random.PRNGKey(3), 34, 9, 64, 2)
    params = jax.tree_util.tree_map(np.array, params)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    model = str(tmp_path / 'serve.pkl')
    jax_save(model, params, bn, meta={})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.Popen([sys.executable, '-m', 'monoloco_tpu_torch.serve', '--model', model,
                             '--port', '0', '--dp_devices', '2', '--disable-cuda'],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True).start()
    try:
        line = ''
        while 'serving' not in line:
            line = lines.get(timeout=TIMEOUT)
        port = int(re.search(r':(\d+)\s', line).group(1))
        assert 'dp2 mesh' in line
        single = Loco((params, bn), device='cpu')
        kk = [[718.0, 0.0, 600.0], [0.0, 718.0, 180.0], [0.0, 0.0, 1.0]]
        rng = np.random.RandomState(0)
        for m in (1, 3, 5, 8):
            kps = (rng.rand(m, 3, 17) * 300).astype(np.float32)
            out = _post(port, {'keypoints': kps.tolist(), 'kk': kk})['outputs']
            ref = single.forward_batch([kps], [kk])[0]
            for key in ('xyzd', 'bi', 'h', 'w', 'l'):
                got = np.asarray(out[key], np.float32)
                want = np.asarray(ref[key], np.float32)
                assert np.all(np.abs(got - want) <= SERVE_TOL * (1 + np.abs(want))), key
    finally:
        proc.terminate()
        proc.wait(timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.read()


def test_dryrun_multichip_toy_runs_dp2_tp2(monkeypatch, capsys):
    monkeypatch.setenv('MONOLOCO_DRYRUN_TOY', '1')
    line = dryrun_multichip(4, device_type='cpu', timeout=TIMEOUT)
    assert 'dp2xtp2 train step ok (hidden 64, 2 stages, batch 16)' in line
    assert line in capsys.readouterr().out
    loss = float(re.search(r'loss=([-\d.]+)', line).group(1))
    assert np.isfinite(loss)
