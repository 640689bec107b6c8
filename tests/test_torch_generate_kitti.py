"""The port's GenerateKitti (`eval --generate`) against the JAX package's on
the CPU, txt tree against txt tree, row by row.

One dataset: the port's synthetic KITTI generator in hard mode (crowds,
occlusion, truncation, misses and false positives), seed 1, 16 train and 24
val scenes, no images; it runs in a copy under each test's tmp_path, since
the pipelines read and write relative to the working directory. Mono runs
the JAX-trained `tests/goldens/byte_compat/model_tpu.pkl` (hidden 128, 3
stages); stereo a MonStereo net (68 -> 10, hidden 128, 3 stages) from the
JAX package's init, its output biases set ahead of the camera, saved with
the JAX `save_checkpoint`.

Tolerances: the same files, the same rows in the same order, the text
columns (type, truncation, occlusion) and boxes equal; every other float
within 1e-5 (1e-5 relative too, as the port's engine tests hold decoded
outputs: both sides print `%f`, so a last-ulp f32 difference can move the
sixth decimal), stereo x, y, z within 1e-4, conf within 1e-5 relative
(or the one unit of the sixth decimal that `%f` can flip).
MC dropout: given JAX's keep-masks and uniforms, epi within 1e-4 relative;
on the port's own generators, JAX's epi inside the range of 40 seeds of the
port widened by 10% of it on each side (the rule of tests/test_torch_mc.py,
there with 20 seeds and 5 detections: here 96 detections share each draw,
and a 21st draw lies outside the range of 20 with chance 2/21), and every
other column equal to the `n_dropout 0` tree. int8 and bf16: the
distance within 0.02 mean relative of the port's own float32 tree (the JAX
package routes int8 only from 512 rows, so its int8 tree is not a
reference).
"""

import argparse
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.eval import GenerateKitti as JaxGenerateKitti
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.models import init_monoloco_params as jax_init_monoloco
from monoloco_tpu.models import save_checkpoint as jax_save
from monoloco_tpu.utils import read_and_rewrite as jax_read_and_rewrite
from monoloco_tpu_torch.eval import GenerateKitti
from monoloco_tpu_torch.models import n_dropout_sites
from monoloco_tpu_torch.network import engine
from monoloco_tpu_torch.tools.eval_parity import txt_tree_diff
from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
HIDDEN, STAGES, P = 128, 3, 0.2
N_DROPOUT = 5
N_SEEDS = 40
TOL = 1e-5
PRINT_ULP = 1e-6           # one unit of the sixth decimal `%f` writes
STEREO_XYZ_TOL = 1e-4
COLS_XYZ = slice(11, 14)
COL_CONF, COL_EPI = 15, 17
BUDGET = 0.02


def _args(mode, model, **kw):
    base = dict(mode=mode, model=model, dir_ann='annotations', n_dropout=0, dropout=P,
                hidden_size=1024, n_stage=3, baselines=False, generate_official=False,
                verbose=False, save=False, show=False, disable_cuda=True)
    base.update(kw)
    return argparse.Namespace(**base)


def _net_dir(mode):
    return os.path.join('data', 'kitti', 'monstereo' if mode == 'stereo' else 'monoloco_pp')


def _read_tree(path):
    """{file name: [row fields]} of a txt tree."""
    tree = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            tree[name] = [line.split() for line in f]
    return tree


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """The dataset, the stereo checkpoint, and the JAX trees of mono, stereo
    and mono with MC dropout (each generated in a copy of the dataset)."""
    base = tmp_path_factory.mktemp('generate_kitti')
    data = base / 'data_root'
    make_dataset(str(data), n_train=16, n_val=24, seed=1, hard=True, images=False)
    params, bn = jax_init(jax.random.PRNGKey(1), 68, 10, HIDDEN, STAGES)
    params = jax.tree_util.tree_map(np.array, params)
    bn = jax.tree_util.tree_map(np.array, bn)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    stereo_model = str(base / 'stereo.pkl')
    jax_save(stereo_model, params, bn)
    old = os.getcwd()
    trees = {}
    try:
        for key, mode, model, n_dropout in (('mono', 'mono', MODEL, 0),
                                            ('stereo', 'stereo', stereo_model, 0),
                                            ('mc', 'mono', MODEL, N_DROPOUT)):
            work = base / f'jax_{key}'
            shutil.copytree(data, work)
            os.chdir(work)
            JaxGenerateKitti(_args(mode, model, n_dropout=n_dropout)).run()
            trees[key] = _read_tree(_net_dir(mode))
    finally:
        os.chdir(old)
    return {'data': data, 'stereo_model': stereo_model, 'jax': trees}


@pytest.fixture
def root(dataset, tmp_path, monkeypatch):
    """A fresh copy of the dataset as the working directory."""
    work = tmp_path / 'root'
    shutil.copytree(dataset['data'], work)
    monkeypatch.chdir(work)
    return work


def _generate(mode, model, **kw):
    gen = GenerateKitti(_args(mode, model, **kw))
    gen.run()
    return gen, _read_tree(_net_dir(mode))


def _assert_trees_close(ours, ref, xyz_tol=TOL, skip=()):
    """Same files, rows, order and text columns; floats by the rules of the
    module docstring. Returns the number of rows."""
    assert list(ours) == list(ref)
    n_rows = 0
    for name in ref:
        assert len(ours[name]) == len(ref[name]), name
        for row, row_ref in zip(ours[name], ref[name]):
            assert len(row) == len(row_ref) == 18
            assert row[:3] == row_ref[:3] and row[4:8] == row_ref[4:8], name
            a = np.array(row[3:], float)
            b = np.array(row_ref[3:], float)
            for col in range(3, 18):
                if col in skip:
                    continue
                if col == COL_CONF:
                    np.testing.assert_allclose(a[col - 3], b[col - 3], rtol=TOL, atol=PRINT_ULP)
                    continue
                tol = xyz_tol if COLS_XYZ.start <= col < COLS_XYZ.stop else TOL
                np.testing.assert_allclose(a[col - 3], b[col - 3], rtol=tol, atol=tol,
                                           err_msg=f'{name} column {col}')
            n_rows += 1
    return n_rows


def test_mono_tree_matches_jax(root, dataset):
    gen, ours = _generate('mono', MODEL)
    assert gen.model.n_dispatches == 1        # 24 images: one chunk
    assert _assert_trees_close(ours, dataset['jax']['mono']) > 50


def test_stereo_tree_matches_jax(root, dataset):
    gen, ours = _generate('stereo', dataset['stereo_model'])
    assert gen.model.net == 'monstereo' and gen.model.n_dispatches == 1
    assert _assert_trees_close(ours, dataset['jax']['stereo'], xyz_tol=STEREO_XYZ_TOL) > 50
    assert {b + '.txt': len(idx) for b, idx in gen.aux_idx.items()} == \
        {name: len(rows) for name, rows in ours.items()}


def test_chunks_are_one_dispatch_each(root, dataset):
    """Chunks of 5 images (the chunk size is run's argument): the same tree,
    one dispatch a chunk."""
    gen = GenerateKitti(_args('mono', MODEL))
    gen.run(chunk=5)
    assert gen.model.n_dispatches == 5
    _assert_trees_close(_read_tree(_net_dir('mono')), dataset['jax']['mono'])


def _jax_mc_draws(rows, n=N_DROPOUT):
    """JAX's keep-masks, site by site in the port's order, and its uniforms
    (the key tree of tests/test_torch_mc.py)."""
    sites = [[] for _ in range(n_dropout_sites(STAGES, 'loco'))]
    for rng in jax.random.split(jax.random.PRNGKey(0), n):
        r = jax.random.split(rng, 4)
        stage_keys = jax.random.split(r[1], 2 * STAGES).reshape(STAGES, 2, 2)
        keys = [r[0]] + [stage_keys[i, j] for i in range(STAGES) for j in (0, 1)] + [r[2]]
        for site, key in zip(sites, keys):
            site.append(np.asarray(jax.random.bernoulli(key, 1.0 - P, (rows, HIDDEN))))
    u = jax.random.uniform(jax.random.PRNGKey(1), (engine.N_SAMPLES, rows),
                           minval=-0.5 + 1e-7, maxval=0.5)
    return [torch.from_numpy(np.stack(s)) for s in sites], torch.from_numpy(np.array(u))


def _epi(tree):
    return np.array([float(row[COL_EPI]) for name in tree for row in tree[name]])


def test_mc_dropout_epi_matches_jax_given_its_draws(root, dataset, monkeypatch):
    monkeypatch.setattr(engine.Loco, 'draw_mc', lambda self, rows: _jax_mc_draws(rows))
    _, ours = _generate('mono', MODEL, n_dropout=N_DROPOUT)
    ref = dataset['jax']['mc']
    _assert_trees_close(ours, ref, skip=(COL_EPI,))
    assert (_epi(ref) > 0).all()
    np.testing.assert_allclose(_epi(ours), _epi(ref), rtol=1e-4, atol=0)


def test_mc_dropout_epi_statistically_matches_jax(root, dataset, monkeypatch):
    """The port's own draws, 40 seeds: every column but epi equals the
    n_dropout 0 tree; JAX's epi inside the seeds' widened range."""
    _, plain = _generate('mono', MODEL)
    runs = []
    for s in range(N_SEEDS):
        def draw(self, rows, s=s):
            return (engine.dropout_masks(self.n_dropout, rows, self.linear_size,
                                         n_dropout_sites(self.n_stage, self.arch),
                                         self.p_dropout, self.device, seed=s),
                    engine.laplace_uniforms(engine.N_SAMPLES, rows, self.device, seed=100 + s))
        monkeypatch.setattr(engine.Loco, 'draw_mc', draw)
        _, ours = _generate('mono', MODEL, n_dropout=N_DROPOUT)
        for name in plain:
            for row, row0 in zip(ours[name], plain[name]):
                assert row[:COL_EPI] == row0[:COL_EPI]
        runs.append(_epi(ours))
    runs = np.stack(runs)
    ref = _epi(dataset['jax']['mc'])
    lo, hi = runs.min(0), runs.max(0)
    width = hi - lo
    assert (width > 0).all()
    assert ((ref >= lo - 0.1 * width) & (ref <= hi + 0.1 * width)).all()


@pytest.mark.parametrize('precision', ['int8', 'bf16'])
@pytest.mark.parametrize('mode', ['mono', 'stereo'])
def test_precision_tree_within_budget_of_float32(root, dataset, monkeypatch, mode, precision):
    """The same detections in the same rows; the distance within 0.02 mean
    relative of the port's float32 tree, and not equal to it (the route
    engaged: every chunk of 24 images is far above the int8 floor)."""
    model = MODEL if mode == 'mono' else dataset['stereo_model']
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'float32')
    _generate(mode, model)
    shutil.copytree(_net_dir(mode), 'txt_float32')
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', precision)
    gen, _ = _generate(mode, model)
    assert gen.model.n_dispatches_int8 == (gen.model.n_dispatches if precision == 'int8' else 0)
    diff = txt_tree_diff('txt_float32', _net_dir(mode))
    assert diff['rows'] > 50 and 0 < diff['mean_rel_dd'] < BUDGET, diff


def test_generate_official_writes_the_official_layout(root, dataset):
    """The net's txts plus an empty file for every one of KITTI's 7481
    images, and the published methods' folders rewritten from their `-orig`
    copies (empty where absent), as the JAX create_empty_files does."""
    orig = os.path.join('data', 'kitti', 'm3d-orig')
    os.makedirs(orig)
    gt_name = sorted(os.listdir(os.path.join('data', 'kitti', 'gt')))[20]
    shutil.copy(os.path.join('data', 'kitti', 'gt', gt_name), os.path.join(orig, gt_name))
    gen = GenerateKitti(_args('mono', MODEL, generate_official=True))
    gen.run()
    names = [str(i).zfill(6) + '.txt' for i in range(7481)]
    ref = dataset['jax']['mono']
    net_dir = _net_dir('mono')
    assert sorted(os.listdir(net_dir)) == names
    for name in names:
        size = os.path.getsize(os.path.join(net_dir, name))
        assert (size > 0) == (name in ref), name
    for method in ('pseudo-lidar', 'monopsr', '3dop', 'm3d', 'oc-stereo', 'e2e', 'monodis',
                   'smoke'):
        d = os.path.join('data', 'kitti', method)
        assert sorted(os.listdir(d)) == names
        for name in names:
            if method == 'm3d' and name == gt_name:
                jax_read_and_rewrite(os.path.join(orig, name), 'jax_rewrite.txt')
                with open(os.path.join(d, name)) as a, open('jax_rewrite.txt') as b:
                    assert a.read() == b.read() != ''
            else:
                assert os.path.getsize(os.path.join(d, name)) == 0


STEREO_TREES = ('monstereo', 'monoloco', 'geometric', 'pose', 'reid')


def _stereo_baselines_root(path):
    """An easy-mode synthetic tree with identity-textured left and right
    images (seed 33, 10 val scenes), a MonStereo checkpoint (JAX init,
    hidden 64, 2 stages, people 15 m ahead) and the legacy MonoLoco one
    (JAX init, hidden 256), as the JAX package's
    `tests/test_kitti_pipeline.py:422` sets up; made the working directory."""
    make_dataset(str(path), n_train=2, n_val=10, seed=33, images=True)
    os.chdir(path)
    os.makedirs(os.path.join('data', 'models'), exist_ok=True)
    params, bn = jax_init_monoloco(jax.random.PRNGKey(0), 34, 2, 256, 3)
    jax_save(GenerateKitti.monoloco_checkpoint, params, bn, meta={'net': 'monoloco'})
    params, bn = jax_init(jax.random.PRNGKey(5), 68, 10, 64, 2)
    params = jax.tree_util.tree_map(np.array, params)
    params['w_fin']['b'][0:3] += np.array([np.pi / 2, np.pi / 2, 15.0], np.float32)
    jax_save('stereo.pkl', params, bn, meta={})


def _stereo_baselines(tmp_path, reid_weights, set_reid=None):
    """`eval --generate --baselines --mode stereo` by both packages, each in
    its own copy of the root: (the port's GenerateKitti, the JAX one, their
    five trees). `set_reid(gen, jgen)` may replace the ReID nets before the
    runs. Leaves the working directory where it was."""
    old = os.getcwd()
    try:
        _stereo_baselines_root(tmp_path / 'ours')
        shutil.copytree('.', tmp_path / 'jax')
        kw = dict(mode='stereo', model='stereo.pkl', baselines=True, hidden_size=64,
                  n_stage=2, reid_weights=reid_weights)
        gen = GenerateKitti(_args(**kw))
        os.chdir(tmp_path / 'jax')
        args = _args(**kw)
        del args.disable_cuda
        jgen = JaxGenerateKitti(args)
        if set_reid:
            set_reid(gen, jgen)
        jgen.run()
        ref = {m: _read_tree(os.path.join('data', 'kitti', m)) for m in STEREO_TREES}
        os.chdir(tmp_path / 'ours')
        gen.run()
        ours = {m: _read_tree(os.path.join('data', 'kitti', m)) for m in STEREO_TREES}
        return gen, jgen, ours, ref
    finally:
        os.chdir(old)


def _assert_reid_trees_close(gen, ours, ref):
    """The reid trees row by row; on a difference, the ReID feature distances
    of each image (left x right, the association's cost) are printed, so a
    row that a near-tie of the features decided shows it."""
    try:
        assert _assert_trees_close(ours, ref) > 10
    except AssertionError:
        from monoloco_tpu_torch.eval.reid_baseline import get_reid_features
        for name in ours:
            base = name[:-4]
            boxes, *_, boxes_r = gen._load_image(base, True)
            if not boxes_r:
                continue
            feats = get_reid_features(gen.reid_net, boxes, boxes_r,
                                      os.path.join(gen.dir_images, base + '.png'),
                                      os.path.join(gen.dir_images_r, base + '.png'))
            print(name, 'reid distances (left x right):')
            print(np.linalg.norm(feats[0][:, None] - feats[1][None], axis=2))
        raise


def test_baselines_are_refused(tmp_path):
    """The name is kept from when the port refused the stereo baselines; they
    run now. `--baselines --mode stereo` without ReID weights: the ResNet-50
    with random weights at 32 x 16 (the JAX test's size), the JAX package's
    `init_resnet50(PRNGKey(1))` carried into the port's net, against the JAX
    package: the five trees row by row, the counters equal, and the
    untrained-ReID warning."""
    from monoloco_tpu.eval.reid_baseline import ReID as JaxReID
    from monoloco_tpu_torch.eval.reid_baseline import ResNet50, params_from_jax

    def set_reid(gen, jgen):
        jgen.reid_net = JaxReID(height=32, width=16)
        gen.reid_net.height, gen.reid_net.width = 32, 16
        gen.reid_net.net = ResNet50(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jgen.reid_net.params)))

    with pytest.warns(RuntimeWarning, match='RANDOMLY INITIALIZED'):
        gen, jgen, ours, ref = _stereo_baselines(tmp_path, None, set_reid)
    for method in STEREO_TREES[:-1]:
        assert _assert_trees_close(ours[method], ref[method]) > 10, method
    _assert_reid_trees_close(gen, ours['reid'], ref['reid'])
    assert dict(gen.cnt_disparity) == dict(jgen.cnt_disparity)
    assert gen.cnt_no_stereo == jgen.cnt_no_stereo and not gen.reid_net.pretrained
