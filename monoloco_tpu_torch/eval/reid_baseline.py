"""Person re-identification features for the stereo association baseline:
`monoloco_tpu/eval/reid_baseline.py` in torch.

- `ResNet50`: the ResNet-50 trunk (conv1, the 3x3/2 max-pool, the (3, 4,
  6, 3) bottlenecks, a global mean) at 256x128 crops, 2048-d features. Eval
  BatchNorm is folded into each convolution, so every conv has a bias.
  Stride 2 sits on the 3x3 conv of a block and on its downsample. The
  padding is JAX's 'SAME': on a strided conv or the max-pool an even size
  pads one more on the bottom and right than on the top and left, and the
  max-pool pads with -inf (`_pad_same`); torch's symmetric `padding=` would
  shift every strided window by one pixel.
- `resnet50_features(params, x)`, the functional form: x (n, 3, h, w).
- `convert_torch_resnet50(state_dict)`: torchvision's names, or the
  reference checkpoint's `base.` prefix and `Sequential` indices (0 conv1,
  1 bn1, 4..7 layer1..4), folded into the port's tree (OIHW).
- `tiny_reid_features`, `init_tiny_reid`, `init_resnet50`: the tiny
  embedding of `tests/fixture_tiny_reid.pkl` and random inits, seeded from
  a `torch.Generator`.
- `params_from_jax(tree)`: a JAX ReID tree (numpy, HWIO) as the port's.
- `ReID`: the tiny `tiny_reid-v1` pickle, else a torch checkpoint, else
  random weights with the JAX package's warning; crops are resized on the
  host (`utils/image.py`, Pillow's BILINEAR bit for bit) and the net runs
  on the given device.
- `get_reid_features`: crop the detections of a stereo pair and embed them.

The convolutions are `torch.nn.functional.conv2d` (cuDNN on the card): the
JAX package computes them with XLA's `conv_general_dilated`, not with a
Pallas kernel. TF32 stays off (`utils/precision.py`).
"""

import pickle
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import precision as _precision  # noqa: F401 — TF32 off for the convolutions
from ..utils.image import crop, read_png_rgb, resize_bilinear

BLOCKS = (3, 4, 6, 3)
EXPANSION = 4
BN_EPS = 1e-5
TINY_HEIGHT, TINY_WIDTH = 64, 32
# ImageNet statistics, as `monoloco_tpu/network/preprocess.py:170-171`.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
UNTRAINED_WARNING = (
    "ReID baseline is running with RANDOMLY INITIALIZED weights — "
    "no Market-1501 checkpoint was provided; its stereo "
    "associations are meaningless. Place converted weights at "
    "data/models/reid_model_market.pkl to fix.")


def _pad_same(x, k, stride, value=0.0):
    """Pad the last two dims of x as XLA's 'SAME' does for a k x k window at
    `stride`: ceil(n / stride) outputs, the odd pixel of the padding at the
    bottom and right."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _conv(x, p, stride=1):
    w = p['w']
    return F.conv2d(_pad_same(x, w.shape[-1], stride), w, p['b'], stride=stride)


def _bottleneck(p, x, stride):
    out = torch.relu(_conv(x, p['conv1']))
    out = torch.relu(_conv(out, p['conv2'], stride))
    out = _conv(out, p['conv3'])
    if 'down' in p:
        x = _conv(x, p['down'], stride)
    return torch.relu(out + x)


def resnet50_features(params, x):
    """(n, 3, h, w) float input -> (n, 2048) pooled features; `params` the
    folded tree ({'conv1': {'w', 'b'}, 'layer1': [blocks], ...}, OIHW)."""
    x = torch.relu(_conv(x, params['conv1'], 2))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-float('inf')), 3, 2)
    for li, n_blocks in enumerate(BLOCKS):
        for bi in range(n_blocks):
            x = _bottleneck(params[f'layer{li + 1}'][bi], x, 2 if bi == 0 and li > 0 else 1)
    return x.mean(dim=(2, 3))


def tiny_reid_features(params, x):
    """(n, 3, 64, 32) float input -> L2-normalized (n, 64) features."""
    for name in ('c1', 'c2', 'c3'):
        x = torch.relu(_conv(x, params[name], 2))
    f = x.mean(dim=(2, 3)) @ params['fc']['w'] + params['fc']['b']
    return f / (torch.linalg.norm(f, dim=1, keepdim=True) + 1e-8)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class ResNet50(nn.Module):
    """The folded ResNet-50 trunk as a module: its tensors are buffers (the
    net only serves), `forward` is `resnet50_features`."""

    def __init__(self, params):
        super().__init__()
        self._keys = []
        for path, leaf in _flatten(params):
            name = '_'.join(path)
            self._keys.append((name, path))
            self.register_buffer(name, torch.as_tensor(leaf, dtype=torch.float32))

    def params(self):
        tree = {}
        for name, path in self._keys:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, name)
        for li in range(len(BLOCKS)):
            blocks = tree[f'layer{li + 1}']
            tree[f'layer{li + 1}'] = [blocks[str(bi)] for bi in range(len(blocks))]
        return tree

    def forward(self, x):
        return resnet50_features(self.params(), x)


def _flatten(tree, prefix=()):
    items = tree.items() if isinstance(tree, dict) else (
        (str(i), v) for i, v in enumerate(tree))
    for key, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _flatten(v, prefix + (key,))
        else:
            yield prefix + (key,), v


def _fold_conv_bn(conv_w, bn):
    """Fold eval BN into a conv: OIHW weight (O, I, kh, kw) and bias."""
    scale = bn['weight'] / np.sqrt(bn['running_var'] + BN_EPS)
    w = np.asarray(conv_w) * scale[:, None, None, None]
    b = bn['bias'] - bn['running_mean'] * scale
    return {'w': torch.as_tensor(w, dtype=torch.float32),
            'b': torch.as_tensor(b, dtype=torch.float32)}


def convert_torch_resnet50(state_dict):
    """A torchvision-style ResNet-50 state_dict (tensors or numpy; keys
    optionally with the reference's 'base.' prefix and `Sequential` indices)
    -> the folded params tree (OIHW), which `ResNet50` takes."""
    sd = {}
    for k, v in state_dict.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        sd[k.replace('base.', '')] = v

    def bn(prefix):
        return {s: sd[f'{prefix}.{s}'] for s in
                ('weight', 'bias', 'running_mean', 'running_var')}

    # The reference checkpoint indexes children of nn.Sequential(resnet.children()):
    # 0=conv1, 1=bn1, 4..7=layer1..4.
    def get(name, alt):
        return name if any(k.startswith(name) for k in sd) else alt

    params = {'conv1': _fold_conv_bn(sd[f"{get('conv1', '0')}.weight"], bn(get('bn1', '1')))}
    for li, n_blocks in enumerate(BLOCKS):
        lkey = get(f'layer{li + 1}', str(4 + li))
        blocks = []
        for bi in range(n_blocks):
            pre = f'{lkey}.{bi}'
            blk = {f'conv{j}': _fold_conv_bn(sd[f'{pre}.conv{j}.weight'], bn(f'{pre}.bn{j}'))
                   for j in (1, 2, 3)}
            if f'{pre}.downsample.0.weight' in sd:
                blk['down'] = _fold_conv_bn(sd[f'{pre}.downsample.0.weight'],
                                            bn(f'{pre}.downsample.1'))
            blocks.append(blk)
        params[f'layer{li + 1}'] = blocks
    return params


def params_from_jax(tree):
    """A JAX ReID params tree (numpy; conv weights HWIO) -> the port's
    (tensors; conv weights OIHW), for the ResNet-50 and the tiny net."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a))
    return _tree_map(leaf, tree)


def _he_conv(gen, cin, cout, ksize):
    w = torch.randn((cout, cin, ksize, ksize), generator=gen) * np.sqrt(2.0 / (ksize * ksize * cin))
    return {'w': w.float(), 'b': torch.zeros(cout)}


def init_tiny_reid(gen, feat_dim=64):
    """The tiny embedding's random init (He-normal convs, zero biases) from
    the torch.Generator `gen` (on the CPU)."""
    return {'c1': _he_conv(gen, 3, 16, 3), 'c2': _he_conv(gen, 16, 32, 3),
            'c3': _he_conv(gen, 32, 64, 3),
            'fc': {'w': torch.randn((64, feat_dim), generator=gen) * np.sqrt(1.0 / 64),
                   'b': torch.zeros(feat_dim)}}


def init_resnet50(gen):
    """A random ResNet-50 tree (He-normal convs, zero biases) from the
    torch.Generator `gen` (on the CPU), for tests and when no pretrained
    weights are available."""
    params = {'conv1': _he_conv(gen, 3, 64, 7)}
    cin = 64
    for li, n_blocks in enumerate(BLOCKS):
        width = 64 * 2 ** li
        blocks = []
        for bi in range(n_blocks):
            blk = {'conv1': _he_conv(gen, cin, width, 1), 'conv2': _he_conv(gen, width, width, 3),
                   'conv3': _he_conv(gen, width, width * EXPANSION, 1)}
            if bi == 0:
                blk['down'] = _he_conv(gen, cin, width * EXPANSION, 1)
            blocks.append(blk)
            cin = width * EXPANSION
        params[f'layer{li + 1}'] = blocks
    return params


class _NumpyUnpickler(pickle.Unpickler):
    """numpy 2 pickles arrays under `numpy._core`; numpy 1.x names it
    `numpy.core`."""

    def find_class(self, module, name):
        if module.startswith('numpy._core') and not hasattr(np, '_core'):
            module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def _load_tiny(path):
    """The params, height and width of a 'tiny_reid-v1' pickle, or None for
    any other file."""
    try:
        with open(path, 'rb') as f:
            blob = _NumpyUnpickler(f).load()
    except Exception:  # noqa: BLE001 — torch checkpoints need torch.load
        return None
    if not (isinstance(blob, dict) and blob.get('format') == 'tiny_reid-v1'):
        return None
    return (params_from_jax(blob['params']), int(blob.get('height', TINY_HEIGHT)),
            int(blob.get('width', TINY_WIDTH)))


class ReID:
    """Crop-and-embed person images with the ResNet-50 (or the tiny net)."""

    def __init__(self, weights_path=None, device=None, num_classes=751, height=256, width=128):
        """`device`: where the net runs (the card when None; `default_device`
        raises without one). `num_classes` is the reference's and unused: the
        features are the trunk's."""
        if device is None:
            from ..network.engine import default_device
            device = default_device()
        self.device = torch.device(device)
        self.height, self.width = height, width
        tiny = _load_tiny(weights_path) if weights_path else None
        if tiny is not None:
            params, self.height, self.width = tiny
            params = _tree_map(lambda t: t.to(self.device), params)
            self.net = lambda x: tiny_reid_features(params, x)
            self.pretrained = True
            print(f"Loaded tiny synthetic-texture ReID weights from "
                  f"'{weights_path}' (NOT Market-1501 — meaningful on synthetic "
                  f"scenes only)")
        elif weights_path:
            # A whole pickled model is taken too, as the JAX package takes it.
            checkpoint = torch.load(weights_path, map_location='cpu', weights_only=False)
            if hasattr(checkpoint, 'state_dict'):
                checkpoint = checkpoint.state_dict()
            params = convert_torch_resnet50({k: v for k, v in checkpoint.items()
                                             if isinstance(v, torch.Tensor)})
            self.pretrained = True
            print(f"Loaded pretrained ReID weights from '{weights_path}'")
        else:
            params = init_resnet50(torch.Generator().manual_seed(1))
            self.pretrained = False
            # Never run this baseline silently untrained: without Market-1501
            # weights the features are random and the associations meaningless.
            warnings.warn(UNTRAINED_WARNING, RuntimeWarning, stacklevel=2)
            print("!" * 79)
            print("! WARNING: ReID running UNTRAINED (random features) — "
                  "reid txts are invalid !")
            print("!" * 79)
        if tiny is None:
            self.net = ResNet50(params).to(self.device)

    def _preprocess(self, images):
        """uint8 (h, w, 3) crops -> (n, 3, height, width) f32 on the device."""
        batch = []
        for im in images:
            arr = resize_bilinear(im, (self.width, self.height)).astype(np.float32) / 255.0
            batch.append((arr - IMAGENET_MEAN) / IMAGENET_STD)
        x = torch.from_numpy(np.stack(batch).transpose(0, 3, 1, 2).copy())
        return x.to(self.device)

    def forward(self, images):
        """Features (n, d) numpy of the uint8 (h, w, 3) crops `images`."""
        with torch.inference_mode():
            return self.net(self._preprocess(images)).cpu().numpy()


def get_reid_features(reid_net, boxes, boxes_r, path_image, path_image_r):
    """Crop the detections of both images of a stereo pair and embed them."""
    image, image_r = read_png_rgb(path_image), read_png_rgb(path_image_r)
    assert boxes and boxes_r
    crops = [crop(image, b[:4]) for b in boxes]
    crops_r = [crop(image_r, b[:4]) for b in boxes_r]
    return reid_net.forward(crops), reid_net.forward(crops_r)
