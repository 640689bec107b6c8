"""The port's EvalKitti and `eval` entry point against the JAX package's, on
the CPU.

EvalKitti is host arithmetic on txt trees, so on the same tree both give
equal statistics, errors, counts, summary table and `eval-<stamp>.json`,
exactly. The tree holds every kind of method folder EvalKitti scores:
MonoLoco++ and MonStereo txts (from the JAX GenerateKitti), the legacy
`monoloco` folder (which adds the analytic task and pixel error bounds), an
external method with the devkit's 16 columns (`m3d`) and the comma-separated
`psf` format. On the port's and the JAX package's generated trees (the rows
within 1e-5, tests/test_torch_generate_kitti.py), ALE and ALP agree within
1e-4. The dataset: the port's synthetic KITTI generator in hard mode, seed 2,
16 train and 24 val scenes; everything runs in a copy under tmp_path.
"""

import argparse
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.eval import EvalKitti as JaxEvalKitti
from monoloco_tpu.eval import GenerateKitti as JaxGenerateKitti
from monoloco_tpu.eval import eval_kitti as jax_eval_kitti
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.models import save_checkpoint as jax_save
from monoloco_tpu_torch import run
from monoloco_tpu_torch.eval import EvalKitti, GenerateKitti
from monoloco_tpu_torch.tools import eval_parity
from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
N_VAL = 24
TOL = 1e-4
KITTI = os.path.join('data', 'kitti')


def _args(mode='mono', model=MODEL, **kw):
    base = dict(mode=mode, model=model, dir_ann='annotations', n_dropout=0, dropout=0.2,
                hidden_size=1024, n_stage=3, baselines=False, generate_official=False,
                verbose=False, save=False, show=False, disable_cuda=True)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """The dataset, a JAX-saved MonStereo checkpoint, and the txt trees of
    both packages' GenerateKitti (mono and stereo), kept beside the data."""
    base = tmp_path_factory.mktemp('eval_kitti')
    data = base / 'data_root'
    make_dataset(str(data), n_train=16, n_val=N_VAL, seed=2, hard=True, images=False)
    params, bn = jax_init(jax.random.PRNGKey(3), 68, 10, 128, 3)
    params = jax.tree_util.tree_map(np.array, params)
    bn = jax.tree_util.tree_map(np.array, bn)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    stereo_model = str(base / 'stereo.pkl')
    jax_save(stereo_model, params, bn)
    old = os.getcwd()
    trees = {}
    try:
        for pkg, gen_cls in (('jax', JaxGenerateKitti), ('port', GenerateKitti)):
            for mode, model in (('mono', MODEL), ('stereo', stereo_model)):
                work = base / f'{pkg}_{mode}'
                shutil.copytree(data, work)
                os.chdir(work)
                gen = gen_cls(_args(mode, model))
                gen.run()
                trees[pkg, mode] = str(work / KITTI / gen.net)
    finally:
        os.chdir(old)
    return {'data': data, 'stereo_model': stereo_model, 'trees': trees}


@pytest.fixture
def root(dataset, tmp_path, monkeypatch):
    work = tmp_path / 'root'
    shutil.copytree(dataset['data'], work)
    monkeypatch.chdir(work)
    return work


def _add_method(src, method):
    shutil.copytree(src, os.path.join(KITTI, method))


def _add_all_methods(dataset):
    """monoloco_pp, monstereo, monoloco (the mono tree), m3d (16 columns) and
    psf (`, `-separated `<id>.png.txt`)."""
    trees = dataset['trees']
    _add_method(trees['jax', 'mono'], 'monoloco_pp')
    _add_method(trees['jax', 'stereo'], 'monstereo')
    _add_method(trees['jax', 'mono'], 'monoloco')
    for method in ('m3d', 'psf'):
        os.makedirs(os.path.join(KITTI, method))
    for name in sorted(os.listdir(trees['jax', 'mono'])):
        with open(os.path.join(trees['jax', 'mono'], name)) as f:
            rows = [line.split()[:16] for line in f]
        with open(os.path.join(KITTI, 'm3d', name), 'w') as f:
            f.writelines(' '.join(r) + '\n' for r in rows)
        stem = os.path.splitext(name)[0]
        with open(os.path.join(KITTI, 'psf', stem + '.png.txt'), 'w') as f:
            f.writelines(', '.join(r) + '\n' for r in rows)


def _plain(tree):
    """defaultdicts (nested) -> dicts, for equality across packages."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _score(cls, args, capsys):
    ev = cls(args)
    # The random-weight MonStereo net's confidences sit below the 0.2 floor,
    # and MonoLoco++'s below m3d's 0.5: score every row of both.
    ev.dic_thresh_conf.update(monstereo=-100, m3d=-100)
    ev.run()
    printed = capsys.readouterr().out
    with open(ev.path_results) as f:
        saved = json.load(f)
    os.remove(ev.path_results)
    return ev, printed, saved


@pytest.mark.parametrize('verbose', [False, True])
@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_eval_kitti_equals_jax_on_one_tree(root, dataset, capsys, mode, verbose):
    _add_all_methods(dataset)
    args = _args(mode, verbose=verbose)
    ref, ref_out, ref_json = _score(JaxEvalKitti, args, capsys)
    ours, our_out, our_json = _score(EvalKitti, args, capsys)
    assert ours.methods == ref.methods and len(ours.methods) == 5
    assert our_out == ref_out
    assert _plain(ours.dic_stats) == _plain(ref.dic_stats)
    assert _plain(ours.errors) == _plain(ref.errors)
    assert _plain(ours.dic_stds) == _plain(ref.dic_stds)
    assert dict(ours.dic_cnt) == dict(ref.dic_cnt) and dict(ours.cnt_gt) == dict(ref.cnt_gt)
    assert our_json == ref_json
    for method in ('monoloco_pp', 'monstereo', 'monoloco', 'm3d', 'psf', 'task_error',
                   'pixel_error'):
        assert ours.errors[method]['all'], method


def test_summary_table_without_tabulate_is_jax_fallback(root, dataset, capsys, monkeypatch):
    """The card's machine has no tabulate: both packages then print their
    fixed-width table, the same."""
    _add_method(dataset['trees']['jax', 'mono'], 'monoloco_pp')
    monkeypatch.setitem(sys.modules, 'tabulate', None)
    monkeypatch.setattr(jax_eval_kitti, 'TABULATE', None)
    ref, ref_out, _ = _score(JaxEvalKitti, _args(), capsys)
    ours, our_out, _ = _score(EvalKitti, _args(), capsys)
    assert our_out == ref_out and 'method  ' in our_out and '-----------  ' not in our_out


@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_port_tree_scores_like_the_jax_tree(root, dataset, mode):
    """Every detection scored (confidence floor -100): ALE per cluster and
    ALP per gate within 1e-4."""
    net = 'monstereo' if mode == 'stereo' else 'monoloco_pp'
    metrics = {}
    for pkg in ('jax', 'port'):
        shutil.rmtree(os.path.join(KITTI, net), ignore_errors=True)
        _add_method(dataset['trees'][pkg, mode], net)
        ev = EvalKitti(_args(mode))
        ev.dic_thresh_conf[net] = -100
        ev.run()
        metrics[pkg] = eval_parity.extract_metrics(ev, net)
    ref, ours = metrics['jax'], metrics['port']
    assert ours['matched'] == ref['matched'] > 20
    for group in ('ale', 'alp'):
        for key, value in ref[group].items():
            assert abs(ours[group][key] - value) <= TOL, (group, key)


@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_cli_generates_and_scores(root, dataset, mode):
    model = MODEL if mode == 'mono' else dataset['stereo_model']
    gen, ev = run.main(['eval', '--generate', '--dir_ann', 'annotations', '--model', model,
                        '--mode', mode, '--disable-cuda'])
    assert gen.model.device == torch.device('cpu') and gen.model.n_dispatches == 1
    assert sorted(os.listdir(os.path.join(KITTI, gen.net))) == \
        sorted(os.listdir(dataset['trees']['jax', mode]))
    with open(ev.path_results) as f:
        stats = json.load(f)
    assert os.path.basename(ev.path_results).startswith('eval-')
    # The random-weight MonStereo net's confidences sit below the 0.2 floor.
    assert mode == 'stereo' or stats['test'][gen.net]['all']['cnt'] > 0


def test_cli_scores_without_generating(root, dataset):
    """Scoring alone is host code: no engine, no card."""
    _add_method(dataset['trees']['jax', 'mono'], 'monoloco_pp')
    gen, ev = run.main(['eval'])
    assert gen is None and ev.methods == ['monoloco_pp']
    assert os.path.exists(ev.path_results)


def test_cli_generate_needs_a_card(root):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: generation runs on it')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        run.main(['eval', '--generate', '--dir_ann', 'annotations', '--model', MODEL])


# The first six cases keep their ids from when the port refused them; they
# run now (`_NOW_RUN`): --activity, --geometric and --variance dispatch before
# --generate, as in the JAX CLI; --baselines (mono) writes the legacy and
# geometric trees; --save and --show draw EvalKitti's figures.
_NOW_RUN = ('--activity', '--geometric', '--variance', '--baselines', '--save', '--show')


@pytest.mark.parametrize('extra,match', [
    (['--activity'], 'item 7'),
    (['--geometric'], 'item 7'),
    (['--variance'], 'item 7'),
    (['--baselines'], 'items 7 and 8'),
    (['--save'], 'item 7'),
    (['--show'], 'item 7'),
    (['--dataset', 'nuscenes', '--dp_devices', '2'], 'item 9'),
    (['--dp_devices', '2'], 'item 9'),
])
def test_unported_eval_options_are_refused(root, capsys, monkeypatch, extra, match):
    """Meshes are refused before anything is generated or scored; the
    options once refused run."""
    argv = ['eval', '--generate', '--dir_ann', 'annotations', '--model', MODEL,
            '--disable-cuda', *extra]
    if extra[0] in _NOW_RUN:
        name = extra[0][2:]
        if name in ('activity', 'geometric', 'variance'):
            monkeypatch.setattr(run, f'eval_{name}', lambda args: ('ran', name))
            assert run.main(argv) == ('ran', name)
            assert not os.path.exists(os.path.join(KITTI, 'monoloco_pp'))
            return
        if name == 'baselines':
            from monoloco_tpu_torch.models import init_monoloco_params, save_checkpoint
            os.makedirs(os.path.join('data', 'models'), exist_ok=True)
            save_checkpoint(GenerateKitti.monoloco_checkpoint,
                            *init_monoloco_params(0, 34, 2, 256, 3))
        gen, ev = run.main(argv)
        trees = ('monoloco_pp', 'monoloco', 'geometric') if name == 'baselines' else \
            ('monoloco_pp',)
        assert set(ev.methods) == set(trees)
        for tree in trees:
            assert len(os.listdir(os.path.join(KITTI, tree))) == N_VAL
        made = sorted(os.listdir(os.path.join('figures', 'results'))) \
            if os.path.isdir(os.path.join('figures', 'results')) else []
        assert made == (['results_monoloco_pp.png', 'spread_monoloco_pp.png', 'task_error.png']
                        if name == 'save' else [])
        return
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code not in (0, None) and match in str(exc.value.code)
    assert not os.path.exists(os.path.join(KITTI, 'monoloco_pp'))


def test_unknown_dataset_is_an_error(root):
    with pytest.raises(ValueError, match='Option not recognized'):
        run.main(['eval', '--dataset', 'coco'])


def test_printer_refuses_figures(root, dataset, monkeypatch):
    """The printer draws the JAX package's figures with matplotlib, and
    without it refuses with an ImportError naming it."""
    _add_method(dataset['trees']['jax', 'mono'], 'monoloco_pp')
    ev = EvalKitti(_args(save=True))
    ev.run()
    EvalKitti(_args()).printer()          # no figures asked: nothing to do
    assert not os.path.exists(os.path.join('figures', 'results'))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, 'matplotlib', None)
        with pytest.raises(ImportError, match='matplotlib'):
            ev.printer()
    ev.printer()
    assert sorted(os.listdir(os.path.join('figures', 'results'))) == [
        'results_monoloco_pp.png', 'spread_monoloco_pp.png', 'task_error.png']


def test_eval_parity_tool_runs_each_precision(root):
    """The tool at tiny size on the CPU: three subprocess legs, the trees'
    rows diffed against float32, int8 routed on every chunk."""
    rec = eval_parity.main(['.', '--model', MODEL, '--disable-cuda'])
    legs = rec['legs']
    assert list(legs) == ['float32', 'int8', 'bf16']
    assert legs['int8']['dispatches_int8'] == legs['int8']['dispatches'] == 1
    assert legs['float32']['dispatches_int8'] == legs['bf16']['dispatches_int8'] == 0
    assert {leg['n_images'] for leg in legs.values()} == {N_VAL}
    for p in ('int8', 'bf16'):
        diff = rec['txt_row_diff'][p]
        assert diff['rows'] > 50 and 0 < diff['mean_rel_dd'] < 0.02
        assert abs(rec['ale_all_delta_pct'][p]) < 2.0
