"""Image reading, cropping and bilinear resizing on the host, without Pillow.

The ReID baseline (`eval/reid_baseline.py`) reads each image, crops every
detection and resizes the crop to the net's input, as the JAX package does
through Pillow's `Image.open(...).convert('RGB')`, `Image.crop` and
`Image.resize(..., Image.BILINEAR)`. The card's machine may have no Pillow,
so these are numpy functions that equal Pillow bit for bit on uint8 RGB:

- `read_png_rgb`: a PNG decoder on `zlib` and numpy for 8-bit RGB and
  RGBA, grey and palette images of 1, 2, 4 or 8 bits without interlace,
  all five row filters; other PNGs and other file types go through Pillow,
  imported only then.
- `crop`: `Image.crop`'s box, rounded with Python's `round` (half to even),
  with pixels outside the image read as 0.
- `resize_bilinear`: Pillow's BILINEAR resize, which is two separable
  passes (horizontal first, a pass skipped when its size does not change)
  of a triangle filter whose support widens by the downscale factor, with
  each output's weights normalized, quantized to 22-bit fixed point, and
  each pass rounded and clipped to uint8.
"""

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # PNG colour type -> samples a pixel
_PRECISION_BITS = 22                            # Pillow's Resample.c, 8 bits a channel


def read_png_rgb(path):
    """The image at `path` as an (h, w, 3) uint8 array, equal to Pillow's
    `Image.open(path).convert('RGB')`."""
    with open(path, 'rb') as f:
        data = f.read()
    decoded = _decode_png(data) if data.startswith(_PNG_SIGNATURE) else None
    if decoded is not None:
        return decoded
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: only 8-bit and palette PNGs without interlace are read "
                          "without Pillow, which is not installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def _chunks(data):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack('>I4s', data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IEND':
            return


def _decode_png(data):
    """(h, w, 3) uint8, or None for a PNG this decoder leaves to Pillow."""
    header, palette, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b'IDAT':
            idat.append(body)
    if header is None:
        return None
    width, height, depth, colour, _, _, interlace = header
    if interlace or colour not in _CHANNELS:
        return None
    channels = _CHANNELS[colour]
    if depth != 8 and not (colour in (0, 3) and depth in (1, 2, 4)):
        return None
    if colour == 3 and palette is None:
        return None
    row_bytes = (width * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    rows = _unfilter(raw[:, 0], raw[:, 1:], max(1, channels * depth // 8))
    if depth < 8:
        samples = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (samples.reshape(height, width, depth) * weights).sum(axis=2).astype(np.uint8)
        if colour == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        pixels = samples[:, :, None]
    else:
        pixels = rows.reshape(height, width, channels)
    if colour == 3:
        index = np.minimum(pixels[:, :, 0], len(palette) - 1)
        return palette[index]
    if channels <= 2:                               # grey, grey + alpha
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _unfilter(types, filtered, bpp):
    """Undo the PNG row filters: `types` (h,) the filter byte of each row,
    `filtered` (h, n) the filtered bytes, `bpp` the bytes a pixel (at least
    1). Pixel (r, i) depends on (r, i - 1), (r - 1, i) and (r - 1, i - 1)
    only, so the rows go together along anti-diagonals: step t decodes
    pixel t - r of every row r, one vectorized step a diagonal."""
    h, n = filtered.shape
    if not types.any():
        return filtered.copy()
    w = n // bpp
    f = filtered.reshape(h, w, bpp).astype(np.int32)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row above, a zero pixel left
    kind = types.astype(np.int32)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h, t + 1))
        i = t - r
        a = x[r + 1, i]          # left
        b = x[r, i + 1]          # above
        c = x[r, i]              # above left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kind[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(k == 3, (a + b) >> 1,
                                                                  np.where(k == 4, paeth, 0))))
        x[r + 1, i + 1] = (f[r, i] + pred) & 255
    return x[1:, 1:].reshape(h, n).astype(np.uint8)


def crop(image, box):
    """`Image.crop(box)` of an (h, w, c) uint8 array: box (x0, y0, x1, y1)
    rounded half to even; pixels outside the image are 0."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    h, w = image.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + image.shape[2:], image.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = image[sy0:sy1, sx0:sx1]
    return out


def _coefficients(in_size, out_size):
    """Pillow's `precompute_coeffs` for the bilinear filter, then
    `normalize_coeffs_8bpc`: the 22-bit fixed-point weights (out, in), each
    output's taps from its xmin to its xmax. The taps' sum runs left to
    right, as Pillow's (a cumulative sum; the zeros before xmin add
    nothing)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale                       # the triangle's support 1, widened
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    x = np.arange(in_size, dtype=np.float64)
    taps = (x[None, :] - center[:, None] + 0.5) * ss
    inside = (x[None, :] >= xmin[:, None]) & (x[None, :] < xmax[:, None])
    k = np.where(inside & (np.abs(taps) < 1.0), 1.0 - np.abs(taps), 0.0)
    total = np.cumsum(k, axis=1)[:, -1:]
    k = np.where(total != 0.0, k / np.where(total != 0.0, total, 1.0), k)
    scaled = k * (1 << _PRECISION_BITS)
    return np.where(scaled < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5))


def _pass(image, weights, axis):
    """One pass along `axis` (0 rows, 1 columns) of uint8 (h, w, c) with
    fixed-point weights (out, in): the sum from 1 << 21, shifted right by 22
    and clipped to 0..255. The sums are integers below 2^31, so float64
    products and sums (BLAS) hold them exactly in any order."""
    acc = np.tensordot(weights, image.astype(np.float64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis).astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(image, size):
    """Pillow's `Image.resize(size, Image.BILINEAR)` of an (h, w, c) uint8
    array, bit for bit; `size` is (width, height)."""
    width, height = size
    h, w = image.shape[:2]
    if width < 1 or height < 1 or w < 1 or h < 1:
        raise ValueError(f"resize of a {w}x{h} image to {width}x{height}")
    out = image
    if width != w:
        out = _pass(out, _coefficients(w, width), axis=1)
    if height != h:
        out = _pass(out, _coefficients(h, height), axis=0)
    return out if out is not image else image.copy()
