"""The port's image module (`monoloco_tpu_torch/utils/image.py`) against
Pillow, bit for bit: the PNG decoder against `Image.open(...).convert('RGB')`
on the repo's fixtures and on PNGs written here by Pillow (RGB, RGBA, L, 1,
P of 4 and 8 bits, odd sizes; `optimize=True` makes Pillow try the Average
filter too) and by the port's synthetic KITTI writer, which between them
use all five row filters; `crop` + `resize_bilinear` against
`Image.crop(box).resize(size, Image.BILINEAR)` on seeded boxes (float
corners, .5 ties, boxes partly outside the image), up- and downscaling to
128 x 256 and 32 x 64.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from monoloco_tpu_torch.tools.make_synthetic_kitti import write_png
from monoloco_tpu_torch.utils.image import crop, read_png_rgb, resize_bilinear

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = ('fixture_000840.png', 'fixture_000840_right.png', 'fixture_002282.png')
N_BOXES = 300
SIZES = ((128, 256), (32, 64))


def _filter_types(path):
    """The filter byte of every row of a non-interlaced PNG."""
    with open(path, 'rb') as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
    width, height, depth, colour = header[:4]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    stride = (width * channels * depth + 7) // 8 + 1
    raw = zlib.decompress(b''.join(idat))
    return {raw[r * stride] for r in range(height)}


def _images():
    """(name, uint8 array) of smooth, noisy and mixed content, odd sizes."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([(xx * 3 + yy * 2) % 256, (xx * yy) % 256, (xx * 5) % 256],
                      -1).astype(np.uint8)
    noise = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    mix = smooth.copy()
    mix[::3] = noise[::3]
    return (('smooth', smooth), ('noise', noise), ('mix', mix))


@pytest.fixture(scope='module')
def written(tmp_path_factory):
    """PNG paths written by Pillow and by the synthetic KITTI writer."""
    d = tmp_path_factory.mktemp('png')
    paths = []
    for name, arr in _images():
        im = Image.fromarray(arr)
        variants = {'RGB': im, 'RGBA': im.convert('RGBA'), 'L': im.convert('L'),
                    '1': im.convert('1'), 'P4': im.quantize(9), 'P8': im.quantize(200)}
        for mode, v in variants.items():
            for optimize in (False, True):
                path = str(d / f'{name}_{mode}_{int(optimize)}.png')
                v.save(path, optimize=optimize)
                paths.append(path)
        path = str(d / f'{name}_synthetic.png')
        write_png(path, arr)
        paths.append(path)
    return paths


def test_written_pngs_use_all_five_filters(written):
    used = set()
    for path in written:
        used |= _filter_types(path)
    assert used == {0, 1, 2, 3, 4}


@pytest.mark.parametrize('name', FIXTURES)
def test_fixture_decodes_as_pillow(name):
    path = os.path.join(HERE, name)
    with Image.open(path) as im:
        ref = np.asarray(im.convert('RGB'))
    out = read_png_rgb(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape == (374, 1238, 3)
    assert np.array_equal(out, ref)


def test_written_pngs_decode_as_pillow(written):
    for path in written:
        with Image.open(path) as im:
            ref = np.asarray(im.convert('RGB'))
        assert np.array_equal(read_png_rgb(path), ref), path


def test_other_files_go_through_pillow(tmp_path):
    """A 16-bit PNG and a JPEG: Pillow reads them."""
    path = str(tmp_path / 'grey16.png')
    Image.fromarray(np.arange(37 * 53, dtype=np.uint16).reshape(37, 53) * 31).save(path)
    jpg = os.path.join(HERE, 'fixture_frame0032.jpg')
    for p in (path, jpg):
        with Image.open(p) as im:
            assert np.array_equal(read_png_rgb(p), np.asarray(im.convert('RGB'))), p


def _boxes():
    rng = np.random.default_rng(7)
    out = []
    for k in range(N_BOXES):
        x0, y0 = rng.uniform(-60, 1200), rng.uniform(-60, 350)
        w, h = rng.uniform(4, 320), rng.uniform(8, 360)
        box = [x0, y0, x0 + w, y0 + h]
        if k % 4 == 0:                      # .5 ties: round half to even
            box = [np.floor(v) + 0.5 for v in box]
        out.append((k, tuple(float(v) for v in box), SIZES[k % 2]))
    return out


@pytest.fixture(scope='module')
def fixture_image():
    path = os.path.join(HERE, 'fixture_000840.png')
    with Image.open(path) as im:
        return read_png_rgb(path), im.convert('RGB')


@pytest.mark.parametrize('k,box,size', _boxes(), ids=lambda v: None)
def test_crop_resize_equals_pillow(fixture_image, k, box, size):
    ours, pil = fixture_image
    ref = np.asarray(pil.crop(box).resize(size, Image.BILINEAR))
    out = resize_bilinear(crop(ours, box), size)
    assert out.shape == ref.shape and np.array_equal(out, ref), (k, box, size)


def test_boxes_cover_up_and_downscaling_and_the_outside():
    boxes = _boxes()
    ratios = [(b[2] - b[0]) / s[0] for _, b, s in boxes] + [(b[3] - b[1]) / s[1]
                                                            for _, b, s in boxes]
    assert min(ratios) < 1 < max(ratios)
    assert any(b[0] < 0 or b[1] < 0 or b[2] > 1238 or b[3] > 374 for _, b, _ in boxes)
