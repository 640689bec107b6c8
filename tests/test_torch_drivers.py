"""The port's drivers against the JAX package's tools of the same names, on
the CPU at small sizes.

- bench_variance: both tools read the same canned bench lines (one run
  failing) through a patched `subprocess.run`; the summaries are equal on
  their shared keys, and the port alone counts the failure (`n_failed`) and
  exits non-zero.
- bench_int8_roofline: one chain pass, `>> 8` and per-row dynamic
  requantization, at B = 256, H = 128 against the JAX tool's body written
  out in numpy (int32 sums, `>> 8`, round half to even): bit for bit.
- bench_generate_full_scale: 8 images from a JAX-written checkpoint through
  both tools; the txt trees agree under the txt rule of
  `tests/test_torch_generate_kitti.py`.
- bench_cli_phases, bench_hyp_search core, bench_mesh_scaling (dp1 and dp2
  over gloo): at hidden 32, the keys of the summary lines and the verdicts.
- train_tiny_reid: one step from the JAX init (`params_from_jax`) on the same
  numpy batch: loss within 1e-5, gradients within 1e-5 of their global norm,
  the Adam update within 1e-5; and a 20-step run whose pickle loads through
  both packages' loaders into the same features.

Alone: python -m pytest tests/test_torch_drivers.py -q
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monoloco_tpu.eval.reid_baseline import ReID as JaxReID
from monoloco_tpu.eval.reid_baseline import init_tiny_reid as jax_init_tiny
from monoloco_tpu.eval.reid_baseline import tiny_reid_features as jax_tiny_features
from monoloco_tpu_torch.eval.reid_baseline import ReID, _load_tiny, params_from_jax
from monoloco_tpu_torch.tools import (bench_cli_phases, bench_generate_full_scale,
                                      bench_hyp_search, bench_int8_roofline,
                                      bench_mesh_scaling, bench_variance, train_tiny_reid)
from test_torch_generate_kitti import _assert_trees_close, _read_tree

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOOLS = os.path.join(REPO, 'tools')
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
TOL = 1e-5


def _jax_tool(name):
    """The JAX package's tools/<name>.py as a module of its own name."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(f'jax_tool_{name}',
                                                  os.path.join(TOOLS, name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def keep_compile_cache(monkeypatch):
    """The JAX tools switch XLA's compile cache to its default directory;
    the suite keeps its own (tests/conftest.py)."""
    import monoloco_tpu.utils
    monkeypatch.setattr(monoloco_tpu.utils, 'enable_compilation_cache', lambda *a, **k: None)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{')]


# ---------------------------------------------------------------- bench_variance

_RUNS = [(0, 9.10e6, 8.40e6, 9.10e6), (0, 9.40e6, 8.60e6, 9.40e6), (1, None, None, None),
         (0, 8.90e6, 9.00e6, 9.00e6), (0, 9.25e6, 8.10e6, 9.25e6), (0, 9.05e6, 8.95e6, 9.05e6)]


def _canned_runs():
    calls = iter(_RUNS)

    def run(cmd, **kwargs):
        rc, int8, bf16, value = next(calls)
        if rc:
            return types.SimpleNamespace(returncode=rc, stdout='', stderr='CUDA error')
        line = {'metric': 'pedestrian_inferences_per_sec', 'value': value,
                'bf16_inferences_per_sec': bf16, 'int8_dyn_inferences_per_sec': int8,
                'device': 'canned'}
        return types.SimpleNamespace(returncode=0, stdout='warm\n' + json.dumps(line) + '\n',
                                     stderr='')
    return run


def test_bench_variance_summary_matches_the_jax_tool(monkeypatch, capsys):
    jax_tool = _jax_tool('bench_variance')
    monkeypatch.setattr(subprocess, 'run', _canned_runs())
    monkeypatch.setattr(sys, 'argv', ['bench_variance.py', str(len(_RUNS))])
    jax_tool.main()
    jax_out = capsys.readouterr().out
    jax_summary = _json_lines(jax_out)[-1]
    monkeypatch.setattr(subprocess, 'run', _canned_runs())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(SystemExit) as exc:
        bench_variance.main([str(len(_RUNS))])
    assert exc.value.code not in (None, 0)
    port_out = capsys.readouterr().out
    summary = _json_lines(port_out)[-1]
    assert summary['n_failed'] == 1 and summary['n'] == len(_RUNS) - 1
    shared = set(jax_summary) & set(summary)
    assert shared >= {'metric', 'n', 'median', 'mean', 'stdev', 'min', 'max',
                      'rel_spread_pct', 'bf16_median', 'bf16_spread_pct', 'int8_dyn_median',
                      'int8_dyn_spread_pct'}
    assert {k: summary[k] for k in shared} == {k: jax_summary[k] for k in shared}
    # Every run's line, the failed one too, as the JAX tool prints them.
    run_lines = [ln for ln in port_out.splitlines() if ln.startswith('run ')]
    assert run_lines == [ln for ln in jax_out.splitlines() if ln.startswith('run ')]


# ---------------------------------------------------------- bench_int8_roofline

def _numpy_chain_pass(x, ws, c, requant):
    """The JAX tool's scan body (tools/bench_int8_roofline.py:108-119) in numpy."""
    y = x ^ np.int8(c & 1)
    for w in ws:
        acc = y.astype(np.int32) @ w.astype(np.int32)
        if requant:
            f = acc.astype(np.float32)
            m = np.max(np.abs(f), axis=1, keepdims=True)
            y = np.round(f * (np.float32(127.0) / np.maximum(m, np.float32(1e-6)))).astype(np.int8)
        else:
            y = (acc >> 8).astype(np.int8)
    return y


@pytest.mark.parametrize('requant', [False, True], ids=['noquant', 'dyn_requant'])
@pytest.mark.parametrize('c', [0, 3])
def test_int8_chain_pass_is_the_jax_body(requant, c):
    x, ws = bench_int8_roofline.chain_inputs(256, 128, 8, 'cpu')
    ours = bench_int8_roofline.chain_pass(x, ws, torch.tensor(c, dtype=torch.int32), requant)
    ref = _numpy_chain_pass(x.numpy(), [w.numpy() for w in ws], c, requant)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert len(np.unique(ref)) > 20                     # not a chain collapsed to 0


def test_int8_chain_requant_rounds_half_to_even():
    # Row max 254, so the scale is 127 / 254 = 0.5 exactly: odd sums land on
    # halves, which go to the even neighbour.
    acc = torch.tensor([[254, 1, 3, 5, -1, -3]], dtype=torch.int32)
    np.testing.assert_array_equal(bench_int8_roofline.requant_rows(acc).numpy(),
                                  [[127, 0, 2, 2, 0, -2]])


def test_int8_roofline_rows_and_summary():
    rows = bench_int8_roofline.measure_rows(batch=256, hidden=128, peak_n=64, device='cpu',
                                            reps=1)
    jax_src = open(os.path.join(TOOLS, 'bench_int8_roofline.py')).read()
    assert [r['which'] for r in rows] == ['peak_int8_8192cubed_tops', 'chain_int8_noquant_tops',
                                          'chain_int8_dyn_requant_tops', 'serve_dyn8',
                                          'summary']
    for name in ('peak_int8_8192cubed_tops', 'chain_int8_noquant_tops',
                 'chain_int8_dyn_requant_tops', 'serve_dyn8', 'pct_of_dyn_requant_ceiling',
                 'pct_of_noquant_ceiling', 'requant_tax_pct', 'l0_head_flop_share_pct'):
        assert f"'{name}" in jax_src, name
    summary = rows[-1]
    assert {'pct_of_dyn_requant_ceiling', 'pct_of_noquant_ceiling', 'pct_of_peak_int8',
            'requant_tax_pct', 'l0_head_flop_share_pct', 'serve_minf_s'} <= set(summary)
    assert summary['published_int8_tops'] == 1979.0
    assert summary['pct_of_noquant_ceiling'] == round(
        100 * summary['serve_trunk_equiv_tops'] / summary['chain_int8_tops'], 1)
    assert all(np.isfinite(r['checksum']) for r in rows[:-1])


# ---------------------------------------------------- bench_generate_full_scale

def test_generate_full_scale_tree_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    jax_tool = _jax_tool('bench_generate_full_scale')
    monkeypatch.setattr(sys, 'argv', ['bench_generate_full_scale.py', str(tmp_path / 'jax'),
                                      '--n_val', '8', '--model', MODEL])
    jax_tool.main()
    monkeypatch.chdir(tmp_path)
    jax_record = _json_lines(capsys.readouterr().out)[-1]
    record = bench_generate_full_scale.main([str(tmp_path / 'port'), '--n_val', '8', '--model',
                                             MODEL, '--disable-cuda'])
    assert os.getcwd() == str(tmp_path)
    assert set(jax_record) <= set(record)
    for key in ('metric', 'n_images', 'txt_written', 'dp_devices'):
        assert record[key] == jax_record[key], key
    assert record['n_images'] == 8 and record['dispatches'] == 1
    tree = os.path.join('data', 'kitti', 'monoloco_pp')
    ours = _read_tree(str(tmp_path / 'port' / tree))
    ref = _read_tree(str(tmp_path / 'jax' / tree))
    assert len(ours) == 8
    assert _assert_trees_close(ours, ref) > 8


def test_generate_full_scale_reuses_a_root_that_holds_a_dataset(tmp_path, capsys):
    from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset
    root = tmp_path / 'hard'
    make_dataset(str(root), n_train=4, n_val=5, seed=1, hard=True, images=False)
    stale = root / 'data' / 'kitti' / 'monoloco_pp'
    stale.mkdir(parents=True)
    for i in range(7):                                 # more txts than the split has images
        (stale / f'stale{i}.txt').write_text('')
    record = bench_generate_full_scale.main([str(root), '--n_val', '3769', '--disable-cuda'])
    assert 'dataset (5 val scenes)' in capsys.readouterr().out
    assert record['n_images'] == record['txt_written'] == 5 and record['dispatches'] == 1
    assert sorted(os.listdir(stale)) == sorted(
        f'{n}.txt' for n in (root / 'splits' / 'kitti_val.txt').read_text().split())
    assert os.path.exists(root / 'data' / 'outputs' / 'fullscale.pkl')


# ------------------------------------------------------------ bench_cli_phases

_PHASE_LINE = re.compile(r'^(imports|Trainer init|train|evaluate): [0-9.]+ s$', re.M)


def test_cli_phases_lines_match_the_jax_tool(tmp_path, monkeypatch, capsys):
    work = tmp_path / 'jax'
    (work / 'tests').mkdir(parents=True)
    shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-mono.json'), work / 'tests')
    monkeypatch.chdir(work)
    _jax_tool('bench_cli_phases').main()
    jax_phases = _PHASE_LINE.findall(capsys.readouterr().out)
    record = bench_cli_phases.phases(str(tmp_path / 'port.pkl'), hidden_size=32,
                                     disable_cuda=True)
    out = capsys.readouterr().out
    assert _PHASE_LINE.findall(out) == jax_phases == ['imports', 'Trainer init', 'train',
                                                      'evaluate']
    assert {'imports_s', 'trainer_init_s', 'train_s', 'evaluate_s'} <= set(record)
    assert record['epochs'] == 5 and record['train_rows'] == 260 and record['device'] == 'cpu'
    assert os.path.exists(tmp_path / 'port.pkl')


# ----------------------------------------------------------- bench_hyp_search

_CORE_LINE = re.compile(r'^HYP core: (.*)$', re.M)


def _core_keys(text):
    return [kv.split('=')[0] for kv in _CORE_LINE.search(text).group(1).split()]


def test_hyp_core_line_matches_the_jax_tool(monkeypatch, capsys):
    jax_tool = _jax_tool('bench_hyp_search')
    jax_args = jax_tool._args

    def small():
        args = jax_args()
        args.hidden_size = 32
        args.joints = os.path.join(HERE, 'fixture_joints-kitti-mono.json')
        return args

    monkeypatch.setattr(jax_tool, '_args', small)
    monkeypatch.setattr(jax_tool, 'EPOCHS', 2)
    jax_tool.run_core()
    jax_keys = _core_keys(capsys.readouterr().out)
    # Hundreds of tiny training steps. Each of the suite's workers starts
    # one torch thread a core, and their pools contend: the port half ran
    # 30x slower in the suite than alone. Alone, one thread is faster too.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        record = bench_hyp_search.run_core(epochs=2, hidden_size=32, disable_cuda=True)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert _core_keys(out) == jax_keys == ['vmapped_24trials', 'serial_24trials',
                                           'ratio_serial_over_vmapped', 'winner_same']
    assert set(jax_keys) <= set(record) and record['trials'] == 24
    assert record['ratio_serial_over_vmapped'] == pytest.approx(
        record['serial_24trials'] / record['vmapped_24trials'])
    assert f"winner_same={record['winner_same']}" in out


# --------------------------------------------------------- bench_mesh_scaling

_VERDICT = re.compile(r'^(train|serve): dp(\d+)/dp1 step-wall ratio ([0-9.]+) \(fixed total '
                      r'batch (\d+)\) -> (OK|PATHOLOGICAL)$', re.M)


def test_mesh_scaling_keys_and_verdicts(monkeypatch, capsys):
    jax_tool = _jax_tool('bench_mesh_scaling')
    canned = {1: 10.0, 2: 11.0, 4: 12.0, 8: 14.0}
    monkeypatch.setattr(jax_tool, 'run_child', lambda dp, batch, hidden, reps, what: {
        'dp': dp, 'what': what, 'median_ms': canned[dp] * (2 if what == 'serve' else 1)})
    monkeypatch.setattr(sys, 'argv', ['bench_mesh_scaling.py'])
    with pytest.raises(SystemExit) as exc:
        jax_tool.main()
    assert exc.value.code == 0
    jax_out = capsys.readouterr().out
    jax_keys = set(_json_lines(jax_out)[0])
    walls = {(what, dp): ms * (2 if what == 'serve' else 1)
             for what in ('train', 'serve') for dp, ms in canned.items()}
    ours = bench_mesh_scaling.verdicts(walls, [1, 2, 4, 8])
    assert [(w, f'{r:.2f}', v) for w, r, v in
            [(w, *ours[w]) for w in ('train', 'serve')]] == \
        [(m[0], m[2], m[4]) for m in _VERDICT.findall(jax_out)]
    assert bench_mesh_scaling.verdicts({**walls, ('train', 8): 15.5}, [1, 8])['train'][1] == \
        'PATHOLOGICAL'

    code = 0
    try:
        bench_mesh_scaling.main(['--widths', '1,2', '--batch', '64', '--hidden', '32',
                                 '--reps', '2', '--disable-cuda'])
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr().out
    lines = _json_lines(out)
    assert [(r['what'], r['dp']) for r in lines] == [('train', 1), ('serve', 1), ('train', 2),
                                                    ('serve', 2)]
    assert all(jax_keys <= set(r) and r['median_step_ms'] > 0 for r in lines)
    found = _VERDICT.findall(out)
    assert [m[0] for m in found] == ['train', 'serve']
    ms = {(r['what'], r['dp']): r['median_step_ms'] for r in lines}
    for what, dp, ratio, batch, verdict in found:
        want = ms[(what, 2)] / ms[(what, 1)]
        assert dp == '2' and batch == '64' and ratio == f'{want:.2f}'
        assert verdict == ('OK' if want <= bench_mesh_scaling.RATIO_LIMIT else 'PATHOLOGICAL')
    assert code == (1 if any(m[4] == 'PATHOLOGICAL' for m in found) else 0)


def test_mesh_scaling_refuses_widths_without_dp1():
    with pytest.raises(SystemExit, match='dp1'):
        bench_mesh_scaling.main(['--widths', '2,4', '--disable-cuda'])


# ------------------------------------------------------------- train_tiny_reid

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flat(tree):
    """{path: array} of a JAX tiny tree, convolutions OIHW like the port's."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out['/'.join(str(p.key) for p in path)] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    return out


def _port_flat(tree, fn=lambda t: t):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f'{k}/{kk}': vv for kk, vv in _port_flat(v, fn).items()})
        else:
            out[k] = fn(v)
    return out


@pytest.fixture(scope='module')
def crops():
    """The JAX tool's crops of 32 identities, and theirs by the port's code."""
    jax_tool = _jax_tool('train_tiny_reid')
    rng_j, rng_p = np.random.RandomState(5), np.random.RandomState(5)
    ids = np.arange(32) % train_tiny_reid.N_IDENTITIES
    xs = np.stack([jax_tool.make_crop(int(i), rng_j) for i in ids]).astype(np.float32)
    ours = np.stack([train_tiny_reid.make_crop(int(i), rng_p) for i in ids])
    return xs, ours, ids


def test_tiny_reid_crops_are_the_jax_tools(crops):
    xs, ours, _ = crops
    assert ours.dtype == np.float32 and ours.shape == (32, 64, 32, 3)
    np.testing.assert_array_equal(ours, xs)


def test_tiny_reid_step_matches_the_jax_step(crops):
    xs, _, ys = crops
    net = jax_init_tiny(jax.random.PRNGKey(0))
    head = (jax.random.normal(jax.random.PRNGKey(7), (64, 64)) * 0.1).astype(jnp.float32)
    trainable = {'net': net, 'head': head}
    opt = optax.adam(train_tiny_reid.LR)

    def loss_fn(tr, x, y):                          # tools/train_tiny_reid.py:72-76
        feats = jax_tiny_features(tr['net'], x)
        return optax.softmax_cross_entropy_with_integer_labels(feats @ tr['head'] * 10.0,
                                                                y).mean()

    loss, grads = jax.value_and_grad(loss_fn)(trainable, jnp.asarray(xs), jnp.asarray(ys))
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)

    trainer = train_tiny_reid.TinyReIDTrainer(
        {'net': params_from_jax(_np_tree(net)), 'head': torch.from_numpy(np.array(head))},
        'cpu')
    before = _port_flat(trainer.trainable, lambda t: t.detach().clone().numpy())
    ours = trainer.step(train_tiny_reid.nchw(xs), torch.from_numpy(ys).long())
    assert abs(float(ours) - float(loss)) <= TOL
    g_ref = _jax_flat(grads)
    g_ours = _port_flat(trainer.trainable, lambda t: t.grad.numpy())
    assert set(g_ours) == set(g_ref)
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in g_ref.values()))
    for key in g_ref:
        assert np.max(np.abs(g_ours[key] - g_ref[key])) <= TOL * norm, key
    u_ref = {k: v - _jax_flat(trainable)[k] for k, v in _jax_flat(new).items()}
    after = _port_flat(trainer.trainable, lambda t: t.detach().numpy())
    for key in u_ref:
        assert np.max(np.abs((after[key] - before[key]) - u_ref[key])) <= TOL, key


def test_tiny_reid_short_run_loads_through_both_loaders(tmp_path, crops):
    xs, ys = train_tiny_reid.training_set()
    trainer = train_tiny_reid.TinyReIDTrainer(train_tiny_reid.init_trainable(), 'cpu')
    loss = trainer.train(xs, ys, 20)
    assert np.isfinite(loss)
    acc, n_ids = train_tiny_reid.holdout_accuracy(trainer)
    assert n_ids == 96 and 0.0 <= acc <= 1.0
    path = str(tmp_path / 'tiny.pkl')
    train_tiny_reid.save(path, trainer.trainable['net'], 20, acc)
    params, height, width = _load_tiny(path)
    assert (height, width) == (64, 32)
    for key, value in _port_flat(trainer.trainable['net'], lambda t: t.detach()).items():
        assert torch.equal(_port_flat(params)[key], value), key
    jax_reid = JaxReID(weights_path=path)
    assert jax_reid.pretrained and (jax_reid.height, jax_reid.width) == (64, 32)
    x = crops[0][:8]
    ref = np.asarray(jax_tiny_features(jax_reid.params, jnp.asarray(x)))
    np.testing.assert_allclose(trainer.features(x), ref, atol=TOL)
    reid = ReID(weights_path=path, device='cpu')
    assert reid.pretrained
