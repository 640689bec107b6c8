"""The port's predict CLI (`monoloco_tpu_torch.run.main`) against the JAX
package's predict on the same images, pifpaf JSONs and checkpoint.

Both run f32 on the CPU; values agree to 1e-5 (relative and absolute: two
frameworks, two f32 sum orders), host-side fields (boxes, pixel centres,
keypoints, gt flags) exactly.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from monoloco_tpu import predict as jax_predict
from monoloco_tpu import run as jax_run
from monoloco_tpu_torch import run
from monoloco_tpu_torch.predict import image_size

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
TOL = 1e-5
EXACT = ('gt', 'indices', 'boxes', 'uv_kps', 'uv_centers', 'uv_shoulders', 'uv_heads')


def _images(root, n):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        dst = os.path.join(root, f'im{i}.png')
        shutil.copy(os.path.join(HERE, 'fixture_002282.png'), dst)
        shutil.copy(os.path.join(HERE, 'fixture_002282.pifpaf.json'), dst + '.pifpaf.json')
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith('.png'))


def _jax_predict(monkeypatch, argv):
    monkeypatch.setattr(sys, 'argv', ['monoloco_tpu.run', *argv])
    jax_predict.predict(jax_run.cli())


def _compare_dirs(ours_dir, ref_dir, n):
    names = sorted(f for f in os.listdir(ref_dir) if f.endswith('.monoloco.json'))
    assert len(names) == n
    assert sorted(f for f in os.listdir(ours_dir) if f.endswith('.monoloco.json')) == names
    for name in names:
        with open(os.path.join(ours_dir, name)) as f:
            ours = json.load(f)
        with open(os.path.join(ref_dir, name)) as f:
            ref = json.load(f)
        assert list(ours.keys()) == list(ref.keys()), name
        for key in ref:
            if key in EXACT:
                assert ours[key] == ref[key], (name, key)
            else:
                np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                           np.asarray(ref[key], np.float64),
                                           rtol=TOL, atol=TOL, err_msg=f'{name}:{key}')


@pytest.mark.parametrize('n_images', [1, 3])
def test_predict_cli_matches_jax(tmp_path, monkeypatch, n_images):
    """1 image takes the per-image loop, 3 the batched chunk path."""
    imgs = _images(str(tmp_path / 'imgs'), n_images)
    common = ['--mode', 'mono', '--model', MODEL, '--calibration', 'kitti',
              '--output_types', 'json']
    net = run.main(['predict', *imgs, *common, '-o', str(tmp_path / 'ours'),
                    '--disable-cuda'])
    assert net.n_dispatches == (1 if n_images == 3 else n_images)
    assert net.n_dispatches_int8 == 0 and net.precision == 'default'
    _jax_predict(monkeypatch, ['predict', *imgs, *common, '-o', str(tmp_path / 'ref')])
    _compare_dirs(str(tmp_path / 'ours'), str(tmp_path / 'ref'), n_images)


def test_glob_and_json_dir(tmp_path):
    imgs = _images(str(tmp_path / 'imgs'), 3)
    json_dir = tmp_path / 'poses'
    json_dir.mkdir()
    for p in imgs:
        shutil.move(p + '.pifpaf.json', json_dir / (os.path.basename(p) + '.pifpaf.json'))
    run.main(['predict', '--glob', str(tmp_path / 'imgs' / '*.png'), '--json_dir',
              str(json_dir), '--model', MODEL, '--calibration', 'kitti',
              '-o', str(tmp_path / 'out'), '--disable-cuda'])
    assert len(os.listdir(tmp_path / 'out')) == 3


@pytest.mark.parametrize('name', ['fixture_002282.png', 'fixture_000840.png',
                                  'fixture_frame0032.jpg'])
def test_image_size_reads_headers_like_pillow(name):
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        assert tuple(image_size(path)) == im.size


@pytest.mark.parametrize('argv', [
    ['prep', '--dir_ann', 'x'],
    ['train', '--joints', 'x.json'],
    ['eval', '--generate'],
    [],
])
def test_unported_commands_exit_nonzero(argv):
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize('extra,match', [
    (['--mode', 'stereo'], 'stereo'),            # one image: stereo takes pairs
    (['--output_types', 'json', 'multi'], 'json only'),
    (['--activities', 'raise_hand'], 'activities'),
    (['--n_dropout', '5'], 'dropout'),
    (['--webcam'], 'webcam'),
])
def test_unported_predict_options_are_refused(tmp_path, extra, match):
    """Options the port does not take, and an odd number of stereo images."""
    imgs = _images(str(tmp_path / 'imgs'), 1)
    with pytest.raises(SystemExit, match=match):
        run.main(['predict', *imgs, '--model', MODEL, *extra])


def test_missing_poses_name_the_image(tmp_path):
    img = str(tmp_path / 'lonely.png')
    shutil.copy(os.path.join(HERE, 'fixture_002282.png'), img)
    with pytest.raises(FileNotFoundError, match='lonely.png'):
        run.main(['predict', img, '--model', MODEL, '--disable-cuda'])
