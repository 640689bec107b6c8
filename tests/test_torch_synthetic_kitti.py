"""The port's synthetic KITTI generator against the JAX package's
`tools/make_synthetic_kitti.py`, easy and hard mode, two seeds each: the gt,
calib and both annotation trees byte for byte, the split lists equal, and
the images pixel for pixel (Pillow reads both; the port writes its PNGs
with zlib). Without images, every other file is still byte for byte the
same: the easy mode's texture noise is drawn all the same.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
from PIL import Image

from monoloco_tpu_torch.tools import make_synthetic_kitti

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'tools'))

from make_synthetic_kitti import make_dataset as jax_make_dataset  # noqa: E402


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize('seed', [0, 3])
@pytest.mark.parametrize('hard', [False, True])
def test_dataset_is_the_jax_tools(tmp_path, hard, seed):
    ref, ours, bare = tmp_path / 'jax', tmp_path / 'port', tmp_path / 'bare'
    names = jax_make_dataset(str(ref), n_train=3, n_val=4, seed=seed, hard=hard)
    assert make_synthetic_kitti.make_dataset(str(ours), 3, 4, seed, hard) == names
    assert make_synthetic_kitti.make_dataset(str(bare), 3, 4, seed, hard, images=False) == names
    files = _files(ref)
    assert _files(ours) == files
    assert _files(bare) == [f for f in files if not f.endswith('.png')]
    n_png = 0
    for rel in files:
        if rel.endswith('.png'):
            with Image.open(ref / rel) as a, Image.open(ours / rel) as b:
                assert a.mode == b.mode == 'RGB'
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            n_png += 1
        else:
            assert filecmp.cmp(ref / rel, ours / rel, shallow=False), rel
            assert filecmp.cmp(ref / rel, bare / rel, shallow=False), rel
    assert n_png == 7 * (1 if hard else 2)


def test_png_writer_round_trips(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    make_synthetic_kitti.write_png(str(tmp_path / 'x.png'), rgb)
    with Image.open(tmp_path / 'x.png') as im:
        assert im.size == (7, 5)
        np.testing.assert_array_equal(np.asarray(im), rgb)


def test_cli_writes_the_dataset(tmp_path, capsys):
    make_synthetic_kitti.main([str(tmp_path / 'root'), '--n_train', '2', '--n_val', '3',
                               '--seed', '4', '--hard', '--no-images'])
    assert 'wrote 2 train + 3 val scenes' in capsys.readouterr().out
    assert len(os.listdir(tmp_path / 'root' / 'data' / 'kitti' / 'gt')) == 5
    assert not os.path.exists(tmp_path / 'root' / 'data' / 'kitti' / 'images')
