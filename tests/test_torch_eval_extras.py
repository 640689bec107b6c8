"""The port's eval verticals against the JAX package's, on the CPU: the
geometric baseline, the variance study, the stereo association baselines,
the activity evaluator, `eval --generate --baselines` (mono), the result
figures, the 3D box projection, the webcam loop, the CLI's new flags, and
the training stage of `tools.eval_parity`.

Tolerances: host numpy copies are held to 1e-12 (the same code on the same
inputs), the geometric and variance statistics exactly; the baseline txt
trees row by row under the rules of tests/test_torch_generate_kitti.py
(text columns and boxes equal, floats 1e-5, conf 1e-5 relative or one unit
of the sixth decimal); the activity flags, per-tag accuracies and counts
equal (no flag flips on these inputs).
"""

import argparse
import filecmp
import json
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.eval import eval_activity as jax_activity
from monoloco_tpu.eval import eval_variance as jax_variance
from monoloco_tpu.eval import geom_baseline as jax_geom
from monoloco_tpu.eval import stereo_baselines as jax_stereo_baselines
from monoloco_tpu.eval import GenerateKitti as JaxGenerateKitti
from monoloco_tpu.models import init_monoloco_params as jax_init_monoloco
from monoloco_tpu.models import save_checkpoint as jax_save
from monoloco_tpu.visuals import plot_3d_box as jax_box
from monoloco_tpu_torch import run
from monoloco_tpu_torch.eval import GenerateKitti, eval_activity, eval_variance, geom_baseline
from monoloco_tpu_torch.eval import stereo_baselines
from monoloco_tpu_torch.models import init_loco_params, init_monoloco_params, save_checkpoint
from monoloco_tpu_torch.prep import PreprocessKitti
from monoloco_tpu_torch.tools import eval_parity
from monoloco_tpu_torch.tools.make_synthetic_kitti import encode_png, make_dataset
from monoloco_tpu_torch.visuals import plot_3d_box
from test_torch_generate_kitti import (STEREO_TREES, _assert_reid_trees_close,
                                       _assert_trees_close, _read_tree, _stereo_baselines)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
HOST_TOL = 1e-12
FX, CX, CY = 721.5377, 609.5593, 172.854


def _eval_args(**kw):
    base = dict(mode='mono', model=MODEL, dir_ann='annotations', n_dropout=0, dropout=0.2,
                hidden_size=1024, n_stage=3, baselines=False, generate_official=False,
                verbose=False, save=False, show=False, disable_cuda=True, dataset='kitti')
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A hard-mode synthetic KITTI tree with images (seed 21, 24 train and
    40 val scenes), its mono joints from the port's prep, and its
    `gt_activity` files."""
    root = tmp_path_factory.mktemp('extras') / 'root'
    make_dataset(str(root), n_train=24, n_val=40, seed=21, hard=True, images=True)
    old = os.getcwd()
    os.chdir(root)
    try:
        prep = PreprocessKitti(dir_ann='annotations', mode='mono', iou_min=0.3)
        joints, _ = prep.run()
        PreprocessKitti(dir_ann='annotations', mode='mono', iou_min=0.3).process_activity()
    finally:
        os.chdir(old)
    return {'root': root, 'joints': str(root / joints)}


@pytest.fixture
def in_tree(tree, tmp_path, monkeypatch):
    work = tmp_path / 'root'
    shutil.copytree(tree['root'], work)
    monkeypatch.chdir(work)
    return work


# ---------------------------------------------------------------------------
# Geometric baseline, variance study, stereo association
# ---------------------------------------------------------------------------

def test_compute_depth_and_geometric_coordinates_match_jax():
    rng = np.random.default_rng(3)
    kk = [[FX, 0, CX], [0, FX, CY], [0, 0, 1]]
    for _ in range(50):
        a, b = rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.5, 0.5, 3)
        for mode, dy in (('average', 0), ('real', float(rng.uniform(0.3, 0.7)))):
            ours = geom_baseline.compute_depth(a, b, 0.48, mode=mode, dy_met=dy)
            ref = jax_geom.compute_depth(a, b, 0.48, mode=mode, dy_met=dy)
            assert abs(ours - ref) <= HOST_TOL * max(1.0, abs(ref))
    for m in (1, 2, 7, 33):
        kps = np.stack([rng.uniform(0, 1242, (m, 17)), rng.uniform(0, 375, (m, 17)),
                        rng.uniform(0, 1, (m, 17))], axis=1).astype(np.float32)
        zz, centers = geom_baseline.geometric_coordinates(kps, kk)
        zz_j, centers_j = jax_geom.geometric_coordinates(kps, kk)
        np.testing.assert_allclose(zz, zz_j, rtol=HOST_TOL, atol=HOST_TOL)
        np.testing.assert_allclose(centers, centers_j, rtol=HOST_TOL, atol=HOST_TOL)


def test_geometric_baseline_matches_jax(tree, capsys):
    """`eval --geometric` on a prep joints file (the JAX package's
    `tests/test_misc_paths.py:14` case): the same errors per cluster, the
    same printout."""
    ours = geom_baseline.geometric_baseline(tree['joints'])
    out = capsys.readouterr().out
    ref = jax_geom.geometric_baseline(tree['joints'])
    assert ours == ref and 'all' in ours
    assert out == capsys.readouterr().out


def test_joints_variance_matches_jax(tmp_path, monkeypatch):
    """On the stereo fixture as `<joints>_pifpaf.json` (the JAX package's
    `tests/test_untested_modules.py:158` case): the same statistics, and
    the figure written."""
    with open(os.path.join(HERE, 'fixture_joints-kitti-stereo.json')) as f:
        dic = json.load(f)
    with open(tmp_path / 'joints_pifpaf.json', 'w') as f:
        json.dump(dic, f)
    monkeypatch.chdir(tmp_path)
    ours = eval_variance.joints_variance(str(tmp_path / 'joints'), phase='train')
    assert (tmp_path / 'figures' / 'joints_variance.png').exists()
    os.remove(tmp_path / 'figures' / 'joints_variance.png')
    ref = jax_variance.joints_variance(str(tmp_path / 'joints'), phase='train')
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    assert set(ours) == {'pifpaf'} and len(ours['pifpaf']['joints']) == 17


def test_joints_variance_without_matplotlib_keeps_the_statistics(tmp_path, monkeypatch):
    with open(os.path.join(HERE, 'fixture_joints-kitti-stereo.json')) as f:
        dic = json.load(f)
    with open(tmp_path / 'joints_mask.json', 'w') as f:
        json.dump(dic, f)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    out = eval_variance.joints_variance(str(tmp_path / 'joints'))
    assert set(out) == {'mask'} and not (tmp_path / 'figures').exists()


def _random_scene(rng):
    """Left poses and right candidates with plausible disparities."""
    m, r = rng.integers(1, 5), rng.integers(1, 6)
    base = np.zeros((1, 3, 17))
    base[0, 0] = rng.uniform(300, 900) + rng.uniform(-25, 25, 17)
    base[0, 1] = rng.uniform(100, 300) + rng.uniform(-60, 60, 17)
    base[0, 2] = rng.uniform(0, 1, 17)
    kps_l = np.repeat(base, m, axis=0) + rng.uniform(-3, 3, (m, 3, 17))
    kps_r = np.zeros((r, 3, 17))
    for i in range(r):
        kps_r[i, 0] = base[0, 0] - 0.54 * 721 / rng.uniform(4.5, 60) + rng.uniform(-2, 2, 17)
        kps_r[i, 1] = base[0, 1] + rng.uniform(-2, 2, 17)
        kps_r[i, 2] = rng.uniform(0, 1, 17)
    zzs = [float(z) for z in rng.uniform(5, 45, m)]
    return kps_l, kps_r, zzs, (rng.random((m, 16)), rng.random((r, 16)))


def test_baselines_association_matches_jax():
    """pose, reid (on any features) and ml_stereo costs on fuzzed poses (the
    JAX package's `tests/test_reference_parity_stereo.py:215` case)."""
    rng = np.random.default_rng(9)
    keys = ['ml_stereo', 'pose', 'reid']
    for _ in range(40):
        kps_l, kps_r, zzs, feats = _random_scene(rng)
        ours, cnt = stereo_baselines.baselines_association(keys, zzs, kps_l, kps_r, feats)
        ref, cnt_j = jax_stereo_baselines.baselines_association(keys, zzs, kps_l, kps_r,
                                                                feats)
        for key in keys:
            np.testing.assert_allclose(ours[key], ref[key], rtol=HOST_TOL, atol=HOST_TOL)
        assert dict(cnt) == dict(cnt_j)


# ---------------------------------------------------------------------------
# Activity evaluation
# ---------------------------------------------------------------------------

def _compare_evaluators(ours, ref):
    assert dict(ours.all_gt) == dict(ref.all_gt)
    assert {k: list(map(bool, v)) for k, v in ours.all_pred.items()} == \
        {k: list(map(bool, v)) for k, v in ref.all_pred.items()}
    assert {k: dict(v) for k, v in ours.cnt.items()} == {k: dict(v) for k, v in ref.cnt.items()}
    for tag in ref.all_gt:
        assert eval_activity.accuracy_score(ours.all_gt[tag], ours.all_pred[tag]) == \
            jax_activity.accuracy_score(ref.all_gt[tag], ref.all_pred[tag])


def test_activity_kitti_matches_jax(in_tree, capsys):
    """Social distancing on the tree's `gt_activity` files (the JAX
    package's `tests/test_kitti_pipeline.py:140` case)."""
    ours = eval_activity.ActivityEvaluator(_eval_args())
    ours.eval_kitti()
    out = capsys.readouterr().out
    args = _eval_args()
    del args.disable_cuda
    ref = jax_activity.ActivityEvaluator(args)
    ref.eval_kitti()
    assert len(ref.all_pred['all']) > 20 and any(ref.all_gt['all'])
    _compare_evaluators(ours, ref)
    assert 'Final Accuracy' in out


def _collective_fixture(pif_dir, rng):
    """The Collective Activity layout (`data/activity/dataset/{images,
    annotations}` + pifpaf files in `pif_dir`) for the six default
    sequences: each frame holds one to four people at 5-9 m, some close
    enough for an F-formation test, labels 'talking' (category 6) at
    random. Frame images are flat JPEGs (their header gives the size)."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from make_synthetic_kitti import make_person
    from PIL import Image
    im_dir = os.path.join('data', 'activity', 'dataset', 'images')
    gt_dir = os.path.join('data', 'activity', 'dataset', 'annotations')
    for d in (im_dir, gt_dir, pif_dir):
        os.makedirs(d, exist_ok=True)
    for seq in jax_activity.DEFAULT_SEQUENCES:
        lines = []
        for frame in range(1, 4):
            name = f'{seq}_frame{frame:04d}.jpg'
            Image.new('RGB', (1242, 375), (80, 80, 80)).save(os.path.join(im_dir, name))
            anns = []
            for _ in range(int(rng.integers(1, 5))):
                x, z = float(rng.uniform(-1.5, 1.5)), float(rng.uniform(5, 9))
                flat, bbox, gt = make_person(x, z, np.random.RandomState(rng.integers(1 << 30)))
                b = gt['box']
                cat = '6' if rng.random() < 0.5 else '1'
                lines.append(f"{frame:03d}\t{b[0]:.0f}\t{b[1]:.0f}\t{b[2] - b[0]:.0f}"
                             f"\t{b[3] - b[1]:.0f}\t{cat}")
                anns.append({'keypoints': flat, 'bbox': bbox, 'score': 0.9, 'category_id': 1})
            with open(os.path.join(pif_dir, name + '.predictions.json'), 'w') as f:
                json.dump(anns, f)
        with open(os.path.join(gt_dir, f'{seq}_annotations.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')


def test_activity_collective_matches_jax(tmp_path, monkeypatch):
    """Talking on the Collective layout: the same flags, per-sequence
    accuracies and counts as the JAX package (whose image size comes from
    Pillow, the port's from the JPEG header)."""
    monkeypatch.chdir(tmp_path)
    _collective_fixture('collective_ann', np.random.default_rng(5))
    ours = eval_activity.ActivityEvaluator(_eval_args(dir_ann='collective_ann',
                                                      dataset='collective'))
    ours.eval_collective()
    args = _eval_args(dir_ann='collective_ann', dataset='collective')
    del args.disable_cuda
    ref = jax_activity.ActivityEvaluator(args)
    ref.eval_collective()
    assert ref.cnt['gt']['all'] > 20
    _compare_evaluators(ours, ref)


# ---------------------------------------------------------------------------
# --generate --baselines
# ---------------------------------------------------------------------------

def test_mono_baselines_trees_match_jax(in_tree, tmp_path):
    """The monoloco_pp, monoloco (legacy net from the JAX init, hidden 256)
    and geometric trees, row by row (the JAX package's
    `tests/test_kitti_pipeline.py:380` case)."""
    os.makedirs(os.path.join('data', 'models'), exist_ok=True)
    params, bn = jax_init_monoloco(jax.random.PRNGKey(0), 34, 2, 256, 3)
    jax_save(GenerateKitti.monoloco_checkpoint, params, bn, meta={'net': 'monoloco'})
    ref_root = tmp_path / 'jax'
    shutil.copytree('.', ref_root)
    gen = GenerateKitti(_eval_args(baselines=True))
    gen.run()
    assert gen.monoloco.net == 'monoloco' and gen.monoloco.linear_size == 256
    ours = {m: _read_tree(os.path.join('data', 'kitti', m))
            for m in ('monoloco_pp', 'monoloco', 'geometric')}
    old = os.getcwd()
    os.chdir(ref_root)
    try:
        args = _eval_args(baselines=True)
        del args.disable_cuda
        JaxGenerateKitti(args).run()
        ref = {m: _read_tree(os.path.join('data', 'kitti', m)) for m in ours}
    finally:
        os.chdir(old)
    for method in ours:
        assert _assert_trees_close(ours[method], ref[method]) > 50, method
    assert gen.model.n_dispatches == gen.monoloco.n_dispatches == len(ours['monoloco_pp'])


def test_stereo_baselines_are_refused(tmp_path, capsys):
    """The name is kept from when the port refused the stereo baselines; they
    run now. `--baselines --mode stereo` with the tiny ReID fixture
    (`--reid_weights`), against the JAX package's: the monstereo, monoloco,
    geometric, pose and reid trees row by row (the reid rows are the pose
    rows' association by ReID features: the same left-right pairs give the
    same depths), and the counters equal."""
    old = os.getcwd()
    try:
        gen, jgen, ours, ref = _stereo_baselines(
            tmp_path, os.path.join(HERE, 'fixture_tiny_reid.pkl'))
    finally:
        os.chdir(old)
    for method in STEREO_TREES[:-1]:
        assert _assert_trees_close(ours[method], ref[method]) > 10, method
    _assert_reid_trees_close(gen, ours['reid'], ref['reid'])
    assert dict(gen.cnt_disparity) == dict(jgen.cnt_disparity)
    assert gen.cnt_disparity['reid'] > 0 and gen.cnt_disparity['pose'] > 0
    assert gen.cnt_no_stereo == jgen.cnt_no_stereo
    assert gen.reid_net.pretrained and gen.reid_net.height == 64
    out = capsys.readouterr().out
    assert 'STEREO:' in out and 'Annotations corrected using reid baseline' in out


def test_init_monoloco_params_has_the_jax_layout():
    ours = init_monoloco_params(0, 34, 2, 256, 3)
    ref = jax_init_monoloco(jax.random.PRNGKey(0), 34, 2, 256, 3)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key if hasattr(key, 'key') else key.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path


# ---------------------------------------------------------------------------
# Figures, 3D boxes
# ---------------------------------------------------------------------------

CLUSTERS = ('easy', 'moderate', 'hard', 'all', '3', '5', '7', '9', '11', '13', '15', '17', '19',
            '21', '23', '25', '27', '29', '31', '49')


def _stats_tree(methods):
    from collections import defaultdict
    rng = np.random.RandomState(0)
    tree = defaultdict(lambda: defaultdict(lambda: defaultdict(float)))
    for m in methods:
        for clst in CLUSTERS[:-1]:
            tree[m][clst]['mean'] = float(0.3 + rng.rand())
            tree[m][clst]['std_ale'] = float(0.5 + 0.5 * rng.rand())
    return {'test': tree}


def test_figures_match_jax_names_and_values(tmp_path):
    """The figure files of `tests/test_figures.py`, the plotted values and
    `calculate_gmm` equal to the JAX package's."""
    from monoloco_tpu.visuals import figures as jax_figures
    from monoloco_tpu_torch.visuals import figures
    assert figures.get_distances(CLUSTERS) == jax_figures.get_distances(CLUSTERS)
    heights, mu, mm = figures.calculate_gmm(n_samples=200_000, seed=3)
    heights_j, mu_j, mm_j = jax_figures.calculate_gmm(n_samples=200_000, seed=3)
    np.testing.assert_array_equal(heights, heights_j)
    assert (mu, mm) == (mu_j, mm_j)
    stats = _stats_tree(['monoloco_pp', 'monstereo'])
    made = {}
    for name, mod in (('port', figures), ('jax', jax_figures)):
        d = str(tmp_path / name)
        plotted = mod.show_results(stats, CLUSTERS, 'monoloco_pp', d, save=True)
        spread = mod.show_spread(stats, CLUSTERS, 'monstereo', d, save=True)
        mod.show_task_error(d, save=True)
        errors = {'monstereo': {c: list(np.random.RandomState(1).rand(5)) for c in CLUSTERS}}
        mod.show_box_plot(errors, CLUSTERS, d, save=True)
        made[name] = (sorted(os.listdir(d)), plotted, spread)
    assert made['port'] == made['jax']
    assert made['port'][0] == ['box_plot.png', 'results_monoloco_pp.png', 'spread_monstereo.png',
                               'task_error.png']


def test_printer_writes_the_jax_figures(in_tree, tmp_path):
    """`eval --save` after `eval --generate`: EvalKitti's printer writes
    the JAX package's figure names (mono)."""
    run.main(['eval', '--generate', '--dir_ann', 'annotations', '--model', MODEL,
              '--disable-cuda'])
    run.main(['eval', '--save'])
    assert sorted(os.listdir(os.path.join('figures', 'results'))) == [
        'results_monoloco_pp.png', 'spread_monoloco_pp.png', 'task_error.png']


def test_save_without_matplotlib_exits_naming_it(in_tree, monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(SystemExit, match='matplotlib'):
        run.main(['eval', '--save'])


def test_plot_3d_box_matches_jax():
    rng = np.random.default_rng(4)
    kk = np.array([[718.0, 0, 600], [0, 718.0, 180], [0, 0, 1.0]])
    for _ in range(30):
        hwl = rng.uniform(0.4, 2.0, 3)
        xyz = [rng.uniform(-5, 5), rng.uniform(-1, 2), rng.uniform(-2, 40)]
        ry = rng.uniform(-np.pi, np.pi)
        c2, c3 = plot_3d_box.compute_box_3d(hwl, xyz, ry, kk)
        j2, j3 = jax_box.compute_box_3d(hwl, xyz, ry, kk)
        np.testing.assert_allclose(c3, j3, rtol=HOST_TOL, atol=HOST_TOL)
        assert (c2 is None) == (j2 is None)
        if c2 is not None:
            np.testing.assert_allclose(c2, j2, rtol=HOST_TOL, atol=HOST_TOL)
            assert plot_3d_box.project_8p_to_4p(c2) == jax_box.project_8p_to_4p(j2)


# ---------------------------------------------------------------------------
# Webcam
# ---------------------------------------------------------------------------

def _webcam_args(model, **kw):
    args = run.cli(['predict', '--webcam', '--model', model, '--disable-cuda'])
    for key, value in kw.items():
        setattr(args, key, value)
    return args


def test_webcam_requires_cv2_and_openpifpaf(monkeypatch):
    """The JAX package's `tests/test_misc_paths.py:46` case, and its
    openpifpaf twin; through the CLI the error exits non-zero naming it."""
    from monoloco_tpu_torch.visuals.webcam import webcam
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        webcam(_webcam_args(MODEL))
    with pytest.raises(SystemExit, match='opencv'):
        run.main(['predict', '--webcam', '--model', MODEL, '--disable-cuda'])
    monkeypatch.setitem(sys.modules, 'cv2', types.ModuleType('cv2'))
    monkeypatch.setitem(sys.modules, 'openpifpaf', None)
    with pytest.raises(ImportError, match='openpifpaf'):
        webcam(_webcam_args(MODEL))


@pytest.mark.parametrize('outputs,files', [
    ([], ['out_webcam_0.multi.png', 'out_webcam_1.multi.png']),
    (['json'], ['out_webcam_0.monoloco.json', 'out_webcam_1.monoloco.json']),
])
def test_webcam_loop_headless(tmp_path, monkeypatch, outputs, files):
    """The JAX package's `tests/test_webcam.py:77` loop with its stubs: two
    frames through capture, the pose stub, the engine and the Printer
    (saved figures, as there is no interactive backend), or json alone;
    the JAX loop on the same stubs gives the same distances."""
    from test_webcam import _cv2_stub, _pifpaf_stub
    monkeypatch.setitem(sys.modules, 'cv2', _cv2_stub())
    monkeypatch.setitem(sys.modules, 'openpifpaf', _pifpaf_stub())
    monkeypatch.chdir(tmp_path)
    net, frames = run.main(['predict', '--webcam', '--model', MODEL, '--disable-cuda',
                            '--activities', 'raise_hand', '--output_types', *outputs]
                           if outputs else
                           ['predict', '--webcam', '--model', MODEL, '--disable-cuda',
                            '--activities', 'raise_hand'])
    assert frames == 2 and net.n_dispatches == 2
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith('out_webcam')) == files
    if outputs == ['json']:
        with open('out_webcam_0.monoloco.json') as f:
            ours = json.load(f)
        from monoloco_tpu.network import Loco as JaxLoco
        from monoloco_tpu.network import load_calibration, preprocess_pifpaf
        frame = sys.modules['cv2'].VideoCapture(0)
        _, image = frame.read()
        image = sys.modules['cv2'].resize(image, None, fx=144 / 640, fy=144 / 640)
        h, w = image.shape[:2]
        anns = [a.json_data() for a in next(iter(
            sys.modules['openpifpaf'].Predictor().numpy_images([image])))[0]]
        kk = load_calibration('custom', (w, h), focal_length=5.7)
        boxes, kps = preprocess_pifpaf(anns, (w, h))
        jnet = JaxLoco(MODEL, mode='mono')
        ref = jnet.post_process(jnet.forward(kps, kk), boxes, kps, kk)
        np.testing.assert_allclose(ours['dds_pred'], ref['dds_pred'], rtol=1e-5, atol=1e-5)
        assert ours['raising_hand'] == jnet.raising_hand(ref, kps)['raising_hand']


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_dispatches_every_new_eval_flag(in_tree, tree, monkeypatch, capsys):
    """--activity (kitti), --geometric and --variance run through
    `run.main`, each before --generate, as in the JAX CLI."""
    ev = run.main(['eval', '--activity', '--dataset', 'kitti', '--dir_ann', 'annotations',
                   '--model', MODEL, '--generate', '--disable-cuda'])
    assert isinstance(ev, eval_activity.ActivityEvaluator) and ev.all_pred['all']
    assert not os.path.exists(os.path.join('data', 'kitti', 'monoloco_pp'))
    assert run.main(['eval', '--geometric', '--joints', tree['joints']]) == \
        jax_geom.geometric_baseline(tree['joints'])
    shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-stereo.json'), 'j_pifpaf.json')
    out = run.main(['eval', '--variance', '--joints', 'j'])
    assert set(out) == {'pifpaf'} and os.path.exists(os.path.join('figures',
                                                                  'joints_variance.png'))
    for argv in (['eval', '--activity'], ['eval', '--geometric'], ['eval', '--variance']):
        with pytest.raises(SystemExit, match='required'):
            run.main(argv)


@pytest.mark.parametrize('argv,reason', [
    (['eval', '--generate', '--baselines', '--mode', 'stereo'], 'item 8'),
    (['eval', '--dp_devices', '2'], 'item 9'),
    (['train', '--out', 'm.orbax'], 'imports jax'),
    (['train', '--resume', 'm.orbax'], 'imports jax'),
    (['train', '--dp_devices', '2'], 'item 9'),
])
def test_cli_refusals_name_their_reason(in_tree, tree, argv, reason):
    """orbax paths are refused naming their reason. The cases of ROADMAP
    items 8 and 9 keep their ids from when the port refused them; they run
    now: the stereo baselines write their five trees, `eval --generate
    --dp_devices 2` and `train --dp_devices 2` run over a gloo mesh."""
    if argv[0] == 'train':
        argv = argv + ['--joints', tree['joints'], '--disable-cuda']
    else:
        argv = argv + ['--dir_ann', 'annotations', '--model', MODEL, '--disable-cuda']
    if reason == 'item 8':
        os.makedirs(os.path.join('data', 'models'), exist_ok=True)
        save_checkpoint(GenerateKitti.monoloco_checkpoint,
                        *init_monoloco_params(0, 34, 2, 256, 3))
        params, bn = init_loco_params(0, 68, 10, 64, 2)
        params['w_fin']['b'][0:3] += torch.tensor([np.pi / 2, np.pi / 2, 15.0])
        save_checkpoint('stereo.pkl', params, bn)
        # The hard-mode tree has left images only; the JAX test copies them.
        shutil.copytree(os.path.join('data', 'kitti', 'images'),
                        os.path.join('data', 'kitti', 'images_r'))
        argv[argv.index(MODEL)] = 'stereo.pkl'
        gen, ev = run.main(argv + ['--hidden_size', '64', '--n_stage', '2', '--reid_weights',
                                   os.path.join(HERE, 'fixture_tiny_reid.pkl')])
        for method in ('monstereo', 'monoloco', 'geometric', 'pose', 'reid'):
            assert method in ev.methods
            assert len(os.listdir(os.path.join('data', 'kitti', method))) == 40
        return
    if reason == 'item 9':
        extra = (['--epochs', '1', '--hidden_size', '32', '--n_stage', '2', '--no_save']
                 if argv[0] == 'train' else ['--generate'])
        out = run.main(argv + extra)
        mesh = (out if argv[0] == 'train' else out[0].model).mesh
        assert mesh.dp == 2 and mesh.tp == 1
        return
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code not in (0, None) and reason in str(exc.value.code)


# ---------------------------------------------------------------------------
# tools.eval_parity --train
# ---------------------------------------------------------------------------

def test_eval_parity_make_root_matches_jax(tmp_path):
    """The root the training stage builds equals the JAX head-to-head's
    (`tools/head_to_head.py:make_root`) for the same scenes and seed: every
    text file byte for byte, every image pixel for pixel."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import head_to_head
    from PIL import Image
    ours, ref = str(tmp_path / 'ours'), str(tmp_path / 'ref')
    eval_parity.make_root(ours, 'mono', 40, 10)
    saved = (head_to_head.N_TRAIN, head_to_head.N_VAL, head_to_head.HARD)
    head_to_head.N_TRAIN, head_to_head.N_VAL, head_to_head.HARD = 40, 10, True
    try:
        head_to_head.make_root(ref, 'mono')
    finally:
        head_to_head.N_TRAIN, head_to_head.N_VAL, head_to_head.HARD = saved
    files = []
    for base, _, names in os.walk(ref):
        for name in names:
            rel = os.path.relpath(os.path.join(base, name), ref)
            files.append(rel)
            if rel.endswith('.png'):
                a = np.asarray(Image.open(os.path.join(ours, rel)))
                b = np.asarray(Image.open(os.path.join(ref, rel)))
                np.testing.assert_array_equal(a, b)
            else:
                assert filecmp.cmp(os.path.join(ours, rel), os.path.join(ref, rel),
                                   shallow=False), rel
    ours_files = [os.path.relpath(os.path.join(b, n), ours)
                  for b, _, ns in os.walk(ours) for n in ns]
    assert sorted(ours_files) == sorted(files) and len(files) > 150
    assert encode_png(np.full((2, 3, 3), 90, np.uint8))[:8] == b'\x89PNG\r\n\x1a\n'


def test_eval_parity_train_stage(tmp_path):
    """`--train` at a tiny size on the CPU (40 + 10 scenes, 2 epochs): the
    stages in their subprocesses, the checkpoint, the three legs and the
    record's keys."""
    rec = eval_parity.main([str(tmp_path / 'root'), '--train', '--n_train', '40', '--n_val',
                            '10', '--epochs', '2', '--disable-cuda'])
    for key in ('n_train', 'n_val', 'epochs', 'r_seed', 'train_wall_s', 'samples_per_s',
                'n_train_rows', 'jax_reference', 'vs_jax', 'legs', 'txt_row_diff'):
        assert key in rec, key
    assert (rec['n_train'], rec['n_val'], rec['epochs'], rec['r_seed']) == (40, 10, 2, 1)
    assert rec['device'] == 'cpu' and rec['n_train_rows'] > 100
    assert rec['jax_reference']['matched'] == 7253
    assert rec['jax_reference']['ale_all_mean'] == pytest.approx(1.290, abs=5e-4)
    assert rec['jax_reference']['alp_1m_mean'] == pytest.approx(42.38, abs=5e-3)
    assert set(rec['legs']) == {'float32', 'int8', 'bf16'}
    assert rec['legs']['int8']['dispatches_int8'] == 1
    assert os.path.exists(tmp_path / 'root' / 'data' / 'outputs' / 'eval_parity.pkl')
    stereo = eval_parity.JAX_REFERENCE['stereo']
    assert stereo['matched'] == 2622 and (stereo['n_train'], stereo['n_val']) == (928, 942)
    assert stereo['ale_all_mean'] == pytest.approx(0.761, abs=5e-4)
    assert stereo['alp_1m_mean'] == pytest.approx(56.44, abs=5e-3)
