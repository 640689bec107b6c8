"""The port's OpenPifPaf branch of predict (`monoloco_tpu_torch/predict.py`
`run_pifpaf`, `load_annotations`) through the in-repo stub of the library
(`tests/stubs/openpifpaf`, loaded as `tests/test_pifpaf_stub.py` loads it),
and against the JAX package's predict on the same stub.

- `run_pifpaf` forwards the args namespace to both configure hooks,
  defaults `force_complete_pose` to true and `device` to the CPU here,
  makes one Predictor per checkpoint, and downgrades a configure hook that
  fails on a partial namespace to a warning.
- Head to head: images without a pifpaf JSON, the stub yielding the
  fixture's annotations (stereo: the right image's poses shifted by a
  disparity); the port's and the JAX package's predict write the same
  `.monoloco.json` files within the predict rules of
  tests/test_torch_predict.py (1e-5) and tests/test_torch_stereo.py
  (stereo 1e-4, confs 1e-3), and the same `--json-output` files; mono per
  image, mono batched, stereo per pair and batched, `--mode keypoints`.
- Without a JSON and without openpifpaf, the JAX package's message.
"""

import argparse
import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest

from monoloco_tpu import predict as jax_predict
from monoloco_tpu import run as jax_run
from monoloco_tpu_torch import predict as port_predict
from monoloco_tpu_torch import run
from monoloco_tpu_torch.geometry import stereo
from test_torch_predict import EXACT, MODEL, _compare_dirs
from test_torch_stereo import checkpoints  # noqa: F401  (module fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
STUBS = os.path.join(HERE, 'stubs')
FIXTURE_IMAGE = os.path.join(HERE, 'fixture_002282.png')
FIXTURE_PIFPAF = os.path.join(HERE, 'fixture_002282.pifpaf.json')
STEREO_TOL, CONF_TOL = 1e-4, 1e-3


def _purge_openpifpaf_modules():
    for name in [m for m in list(sys.modules)
                 if m == 'openpifpaf' or m.startswith('openpifpaf.')]:
        del sys.modules[name]


@pytest.fixture
def stub_pifpaf(monkeypatch):
    """The stub imported as `openpifpaf`, its recorders reset, and both
    packages' predictor caches cleared; undone afterwards."""
    real = sys.modules.get('openpifpaf')
    if real is not None and STUBS not in (real.__file__ or ''):
        pytest.skip('real openpifpaf installed; the gated job covers this')
    monkeypatch.syspath_prepend(STUBS)
    _purge_openpifpaf_modules()
    import openpifpaf
    assert STUBS in openpifpaf.__file__, 'stub did not win the import'
    openpifpaf.reset()
    with open(FIXTURE_PIFPAF) as f:
        openpifpaf.set_annotations(json.load(f))
    port_predict._PIFPAF_PREDICTOR.clear()
    jax_predict._PIFPAF_PREDICTOR.clear()
    yield openpifpaf
    port_predict._PIFPAF_PREDICTOR.clear()
    jax_predict._PIFPAF_PREDICTOR.clear()
    _purge_openpifpaf_modules()


def _pifpaf_args(**over):
    ns = argparse.Namespace(checkpoint='stub-shufflenet', seed_threshold=0.5,
                            instance_threshold=0.15, disable_cuda=True)
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def test_configure_forwarding_and_annotation_contract(stub_pifpaf):
    args = _pifpaf_args()
    assert not hasattr(args, 'force_complete_pose')
    results = list(port_predict.run_pifpaf([FIXTURE_IMAGE, FIXTURE_IMAGE],
                                           checkpoint=args.checkpoint, args=args))
    with open(FIXTURE_PIFPAF) as f:
        fixture = json.load(f)
    assert results == [(FIXTURE_IMAGE, fixture)] * 2
    assert stub_pifpaf.decoder.CONFIGURE_CALLS == [args]
    assert [t for t, _ in stub_pifpaf.CONFIGURE_CALLS] == ['Predictor']
    assert args.force_complete_pose is True and str(args.device) == 'cpu'


def test_an_existing_namespace_value_is_kept(stub_pifpaf):
    args = _pifpaf_args(force_complete_pose=False, device='cuda:1')
    list(port_predict.run_pifpaf([FIXTURE_IMAGE], checkpoint='c', args=args))
    assert args.force_complete_pose is False and args.device == 'cuda:1'


def test_predictor_cached_per_checkpoint(stub_pifpaf):
    for _ in range(3):
        list(port_predict.run_pifpaf([FIXTURE_IMAGE], checkpoint='ckpt-a'))
    assert stub_pifpaf.PREDICTOR_INSTANTIATIONS == ['ckpt-a']
    list(port_predict.run_pifpaf([FIXTURE_IMAGE], checkpoint='ckpt-b'))
    assert stub_pifpaf.PREDICTOR_INSTANTIATIONS == ['ckpt-a', 'ckpt-b']


def test_partial_namespace_warns_but_still_predicts(stub_pifpaf, caplog):
    args = _pifpaf_args(stub_raise_on_configure=True)
    with caplog.at_level(logging.WARNING, logger='monoloco_tpu_torch.predict'):
        results = list(port_predict.run_pifpaf([FIXTURE_IMAGE], checkpoint=args.checkpoint,
                                               args=args))
    assert len(results) == 1 and results[0][1]
    skipped = [r for r in caplog.records if 'configure skipped' in r.message]
    assert len(skipped) == 2        # the decoder and Predictor hooks both
    assert stub_pifpaf.decoder.CONFIGURE_CALLS == stub_pifpaf.CONFIGURE_CALLS == []


def test_a_json_beside_the_image_wins(stub_pifpaf, tmp_path):
    image = str(tmp_path / 'im.png')
    shutil.copy(FIXTURE_IMAGE, image)
    with open(image + '.pifpaf.json', 'w') as f:
        json.dump([], f)
    assert port_predict.load_annotations(image, _pifpaf_args()) == []
    assert stub_pifpaf.PREDICTOR_INSTANTIATIONS == []


def test_without_a_json_or_openpifpaf_the_jax_message(tmp_path, monkeypatch):
    image = str(tmp_path / 'lonely.png')
    shutil.copy(FIXTURE_IMAGE, image)
    monkeypatch.setitem(sys.modules, 'openpifpaf', None)     # import fails
    for package in (port_predict, jax_predict):
        with pytest.raises(FileNotFoundError) as exc:
            package.load_annotations(image, _pifpaf_args())
        assert str(exc.value) == (f"No pifpaf annotations for {image}: provide "
                                  f"<image>.pifpaf.json (or --json_dir), or install openpifpaf")


# --- head to head on the stub ---------------------------------------------

def _bare_images(root, n):
    """n copies of the fixture image, without pifpaf JSON."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        shutil.copy(FIXTURE_IMAGE, os.path.join(root, f'im{i}.png'))
    return sorted(os.path.join(root, f) for f in os.listdir(root))


def _jax_predict(monkeypatch, argv):
    monkeypatch.setattr(sys, 'argv', ['monoloco_tpu.run', *argv])
    jax_predict.predict(jax_run.cli())


def _json_outputs(path):
    return sorted(f for f in os.listdir(path) if f.endswith('.predictions.json'))


@pytest.mark.parametrize('n_images', [1, 3], ids=['per_image', 'batched'])
def test_mono_predict_via_openpifpaf_matches_jax(stub_pifpaf, tmp_path, monkeypatch, n_images):
    """1 image takes the per-image loop, 3 the batched one; both with
    --json-output, whose files hold the stub's annotations. The port's run
    equals its own run on the fixture's JSON bit for bit."""
    imgs = _bare_images(str(tmp_path / 'imgs'), n_images)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti', '--output_types',
              'json', '--checkpoint', 'stub-ckpt', '--json-output']
    net = run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'), '--disable-cuda'])
    assert net.n_dispatches == (1 if n_images == 3 else n_images)
    assert stub_pifpaf.PREDICTOR_INSTANTIATIONS == ['stub-ckpt']
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    _compare_dirs(str(tmp_path / 'ours'), str(tmp_path / 'ref'), n_images)
    names = _json_outputs(tmp_path / 'ours')
    assert names == _json_outputs(tmp_path / 'ref') == [f'im{i}.png.predictions.json'
                                                         for i in range(n_images)]
    with open(FIXTURE_PIFPAF) as f:
        fixture = json.load(f)
    for name in names:
        with open(tmp_path / 'ours' / name) as f, open(tmp_path / 'ref' / name) as g:
            assert json.load(f) == json.load(g) == fixture
    for p in imgs:
        shutil.copy(FIXTURE_PIFPAF, p + '.pifpaf.json')
    run.main(['predict', *imgs, *common[:-1], '-o', str(tmp_path / 'fed'), '--disable-cuda'])
    for i in range(n_images):
        name = f'out_im{i}.png.monoloco.json'
        with open(tmp_path / 'ours' / name) as f, open(tmp_path / 'fed' / name) as g:
            assert f.read() == g.read(), name


def _stereo_stub(stub, monkeypatch, root, n_pairs):
    """n_pairs (left, right) fixture images without JSON; the stub yields
    the fixture's poses for a left image and, for a right one, the same
    poses shifted left by BF / z, z in 5-40 m."""
    with open(FIXTURE_PIFPAF) as f:
        anns = json.load(f)
    os.makedirs(root, exist_ok=True)
    poses = {}
    for i in range(n_pairs):
        rng = np.random.RandomState(100 + i)
        right = []
        for ann in anns:
            shift = stereo.BF / rng.uniform(5, 40)
            kps = list(ann['keypoints'])
            kps[0::3] = [x - shift for x in kps[0::3]]
            box = list(ann['bbox'])
            box[0] -= shift
            right.append({**ann, 'keypoints': kps, 'bbox': box})
        for side, side_poses in (('a', anns), ('b', right)):
            dst = os.path.join(root, f'pair{i}{side}.png')
            shutil.copy(FIXTURE_IMAGE, dst)
            poses[dst] = side_poses

    def images(self, paths, batch_size=1):
        for path in paths:
            yield [stub._Annotation(a) for a in poses[path]], None, {'file_name': path}
    monkeypatch.setattr(stub.Predictor, 'images', images)
    return sorted(poses)


@pytest.mark.parametrize('n_pairs', [1, 3], ids=['per_pair', 'batched'])
def test_stereo_predict_via_openpifpaf_matches_jax(stub_pifpaf, tmp_path, monkeypatch,
                                                   checkpoints, n_pairs):  # noqa: F811
    imgs = _stereo_stub(stub_pifpaf, monkeypatch, str(tmp_path / 'imgs'), n_pairs)
    common = ['--mode', 'stereo', '--model', checkpoints['stereo'], '--calibration', 'kitti',
              '--output_types', 'json', '--json-output']
    net = run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'), '--disable-cuda'])
    assert net.net == 'monstereo' and net.n_dispatches == (1 if n_pairs == 3 else n_pairs)
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    names = sorted(f for f in os.listdir(tmp_path / 'ref') if f.endswith('.monoloco.json'))
    assert names == [f'out_pair{i}a.png.monoloco.json' for i in range(n_pairs)]
    assert sorted(os.listdir(tmp_path / 'ours')) == sorted(os.listdir(tmp_path / 'ref'))
    for name in names:
        with open(tmp_path / 'ours' / name) as f, open(tmp_path / 'ref' / name) as g:
            ours, ref = json.load(f), json.load(g)
        assert list(ours) == list(ref) and ref['dds_pred'], name
        for key in ref:
            if key in EXACT:
                assert ours[key] == ref[key], (name, key)
            else:
                tol = CONF_TOL if key == 'confs' else STEREO_TOL
                np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                           np.asarray(ref[key], np.float64),
                                           rtol=tol, atol=tol, err_msg=f'{name}:{key}')
    for name in _json_outputs(tmp_path / 'ref'):      # left images only
        with open(tmp_path / 'ours' / name) as f, open(tmp_path / 'ref' / name) as g:
            assert json.load(f) == json.load(g)


def test_keypoints_mode_via_openpifpaf_matches_jax(stub_pifpaf, tmp_path, monkeypatch):
    """--mode keypoints builds no net: {} per image, and the annotations
    OpenPifPaf returned under --json-output, as the JAX package writes."""
    imgs = _bare_images(str(tmp_path / 'imgs'), 3)
    argv = ['predict', *imgs, '--mode', 'keypoints', '--output_types', 'json', '--json-output']
    assert run.main(argv + ['-o', str(tmp_path / 'ours'), '--disable-cuda']) is None
    _jax_predict(monkeypatch, argv + ['-o', str(tmp_path / 'ref')])
    assert sorted(os.listdir(tmp_path / 'ours')) == sorted(os.listdir(tmp_path / 'ref'))
    _compare_dirs(str(tmp_path / 'ours'), str(tmp_path / 'ref'), 3)
    for name in _json_outputs(tmp_path / 'ref'):
        with open(tmp_path / 'ours' / name) as f, open(tmp_path / 'ref' / name) as g:
            assert json.load(f) == json.load(g)
    assert len(_json_outputs(tmp_path / 'ours')) == 3
    assert stub_pifpaf.PREDICTOR_INSTANTIATIONS == [None, None]     # one per package
