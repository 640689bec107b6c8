"""The port's ReID baseline (`monoloco_tpu_torch/eval/reid_baseline.py`)
against the JAX package's, on the CPU.

Tolerances: the tiny embedding with the fixture's weights within 1e-5 max
abs (L2-normalized 64-d features); the ResNet-50 (the JAX package's
`init_resnet50(PRNGKey(1))` carried across by `params_from_jax`, 53
convolutions deep) within 1e-4 of the largest feature. The crops each
package feeds its net are equal bit for bit: Pillow's crop and BILINEAR
resize on one side, `utils/image.py` on the other.
"""

import os
import pickle
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from monoloco_tpu.eval import reid_baseline as jax_reid
from monoloco_tpu_torch.eval import reid_baseline
from monoloco_tpu_torch.eval.reid_baseline import (ReID, ResNet50, convert_torch_resnet50,
                                                   get_reid_features, init_resnet50,
                                                   init_tiny_reid, params_from_jax,
                                                   resnet50_features, tiny_reid_features)
from monoloco_tpu_torch.utils.image import crop, read_png_rgb

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = os.path.join(HERE, 'fixture_tiny_reid.pkl')
LEFT = os.path.join(HERE, 'fixture_000840.png')
RIGHT = os.path.join(HERE, 'fixture_000840_right.png')
TINY_TOL = 1e-5
RESNET_TOL = 1e-4          # of max |feature|
BOXES = [(410.3, 160.7, 470.1, 300.2), (700.5, 150.5, 760.5, 330.5),
         (-10.2, 120.0, 60.4, 360.9), (1190.0, 140.2, 1250.7, 380.0)]

sys.path.insert(0, os.path.join(REPO, 'tools'))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _crops(n):
    """(Pillow crops, the port's uint8 crops) of the left fixture."""
    with Image.open(LEFT) as im:
        pil = im.convert('RGB')
    arr = read_png_rgb(LEFT)
    return [pil.crop(b) for b in BOXES[:n]], [crop(arr, b) for b in BOXES[:n]]


def _inputs(h, w, n):
    """The JAX ReID's and the port's preprocessed inputs of n crops at h x w
    (equal bit for bit), as the JAX NHWC array."""
    pil, ours = _crops(n)
    j = jax_reid.ReID.__new__(jax_reid.ReID)
    j.height, j.width = h, w
    ref = np.asarray(j._preprocess(pil))
    p = ReID.__new__(ReID)
    p.height, p.width, p.device = h, w, torch.device('cpu')
    x = p._preprocess(ours)
    assert np.array_equal(x.numpy().transpose(0, 2, 3, 1), ref)
    return ref


def test_tiny_features_match_jax():
    with open(TINY, 'rb') as f:
        blob = pickle.load(f)
    x = _inputs(64, 32, 4)
    ref = np.asarray(jax_reid.tiny_reid_features(blob['params'], x))
    out = tiny_reid_features(params_from_jax(blob['params']), _nchw(x)).numpy()
    assert np.abs(out - ref).max() <= TINY_TOL


@pytest.fixture(scope='module')
def jax_resnet():
    params = jax_reid.init_resnet50(jax.random.PRNGKey(1))
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('hw,n', [((256, 128), 2), ((64, 32), 4)])
def test_resnet50_matches_jax(jax_resnet, hw, n):
    params, params_np = jax_resnet
    x = _inputs(*hw, n)
    ref = np.asarray(jax.jit(jax_reid.resnet50_features)(params, x))
    net = ResNet50(params_from_jax(params_np))
    with torch.no_grad():
        out = net(_nchw(x)).numpy()
        functional = resnet50_features(params_from_jax(params_np), _nchw(x)).numpy()
    assert out.shape == ref.shape == (n, 2048)
    assert np.abs(out - ref).max() <= RESNET_TOL * np.abs(ref).max()
    assert np.array_equal(out, functional)


def _torchvision_state_dict(seed, naming):
    """A ResNet-50 state_dict in torchvision's layout (with an fc head, which
    the trunk ignores), random from a numpy seed; `naming` 'torchvision' or
    'reference' (the 'base.' prefix and Sequential indices)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f'{name}.weight'] = rng.normal(0, np.sqrt(2.0 / (k * k * cin)),
                                          (cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f'{name}.weight'] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f'{name}.bias'] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f'{name}.running_mean'] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f'{name}.running_var'] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    names = ({'conv1': 'conv1', 'bn1': 'bn1', 'layer': 'layer{}'} if naming == 'torchvision'
             else {'conv1': 'base.0', 'bn1': 'base.1', 'layer': 'base.{}'})
    conv(names['conv1'], 64, 3, 7)
    bn(names['bn1'], 64)
    cin = 64
    for li, n_blocks in enumerate(reid_baseline.BLOCKS):
        width = 64 * 2 ** li
        lname = (names['layer'].format(li + 1) if naming == 'torchvision'
                 else names['layer'].format(li + 4))
        for bi in range(n_blocks):
            pre = f'{lname}.{bi}'
            conv(f'{pre}.conv1', width, cin, 1)
            bn(f'{pre}.bn1', width)
            conv(f'{pre}.conv2', width, width, 3)
            bn(f'{pre}.bn2', width)
            conv(f'{pre}.conv3', width * 4, width, 1)
            bn(f'{pre}.bn3', width * 4)
            if bi == 0:
                conv(f'{pre}.downsample.0', width * 4, cin, 1)
                bn(f'{pre}.downsample.1', width * 4)
            cin = width * 4
    sd['fc.weight'] = rng.normal(size=(751, 2048)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize('naming', ['torchvision', 'reference'])
def test_torch_checkpoint_converts_as_in_jax(naming, tmp_path):
    path = str(tmp_path / 'reid.pth')
    torch.save(_torchvision_state_dict(3, naming), path)
    pil, ours = _crops(3)
    ref = jax_reid.ReID(weights_path=path, height=64, width=32).forward(pil)
    reid = ReID(weights_path=path, device='cpu', height=64, width=32)
    assert reid.pretrained and isinstance(reid.net, ResNet50)
    out = reid.forward(ours)
    assert np.abs(out - ref).max() <= RESNET_TOL * np.abs(ref).max()
    direct = ResNet50(convert_torch_resnet50(torch.load(path)))
    with torch.no_grad():
        assert np.array_equal(direct(reid._preprocess(ours)).numpy(), out)


def test_untrained_reid_warns_as_jax(capsys):
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter('always')
        jax_reid.ReID(weights_path=None)
    ref_out = capsys.readouterr().out
    with warnings.catch_warnings(record=True) as our_w:
        warnings.simplefilter('always')
        reid = ReID(weights_path=None, device='cpu')
    assert not reid.pretrained and isinstance(reid.net, ResNet50)
    assert [(w.category, str(w.message)) for w in our_w] == \
        [(w.category, str(w.message)) for w in ref_w]
    assert capsys.readouterr().out == ref_out


def test_tiny_pickle_loads_under_numpy_1_names(monkeypatch):
    """The fixture pickles arrays under numpy 2's `numpy._core`; where numpy
    has no `_core` (1.x) the unpickler maps it to `numpy.core`."""
    monkeypatch.delattr(np, '_core', raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        params, h, w = reid_baseline._load_tiny(TINY)
    assert (h, w) == (64, 32) and tuple(params['c1']['w'].shape) == (16, 3, 3, 3)


def test_tiny_weights_load_without_warning():
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        reid = ReID(weights_path=TINY, device='cpu')
    assert reid.pretrained and (reid.height, reid.width) == (64, 32)


def test_random_inits_have_the_jax_shapes():
    gen = torch.Generator().manual_seed(0)
    for ours, ref in ((init_resnet50(gen), jax_reid.init_resnet50(jax.random.PRNGKey(0))),
                      (init_tiny_reid(gen), jax_reid.init_tiny_reid(jax.random.PRNGKey(0)))):
        carried = params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
        flat_o = jax.tree_util.tree_leaves(ours)
        flat_r = jax.tree_util.tree_leaves(carried)
        assert [tuple(t.shape) for t in flat_o] == [tuple(t.shape) for t in flat_r]


# ---------------------------------------------------------------------------
# The port of tests/test_reid_synthetic.py
# ---------------------------------------------------------------------------

PEOPLE = [
    [(-3.5, 8.0, 0.3), (0.0, 11.0, -0.5), (2.5, 15.0, 0.1),
     (-1.0, 20.0, 0.8), (4.0, 25.0, -0.2)],
    [(-2.0, 7.0, 0.0), (1.5, 9.0, 0.4), (3.0, 13.0, -0.3),
     (-4.0, 17.0, 0.6), (0.5, 22.0, -0.8)],
    [(-1.5, 6.0, 0.2), (2.0, 10.0, -0.1), (-3.0, 12.0, 0.5),
     (4.5, 18.0, -0.6), (1.0, 24.0, 0.3)],
    [(0.0, 8.5, -0.4), (-2.5, 10.5, 0.7), (3.5, 14.0, 0.0),
     (-0.5, 19.0, -0.2), (2.0, 26.0, 0.9)],
]


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """Four synthetic stereo scenes with identity textures (the port's
    writer, byte for byte the JAX tool's), 20 people."""
    import json
    from monoloco_tpu_torch.tools.make_synthetic_kitti import write_scene
    root = str(tmp_path_factory.mktemp('reid_scenes'))
    rng = np.random.RandomState(3)
    out = []
    for idx, people in enumerate(PEOPLE):
        name = write_scene(root, idx, people, rng)
        anns = []
        for side in ('annotations', 'annotations_right'):
            with open(os.path.join(root, side, name + '.png.predictions.json')) as f:
                anns.append(json.load(f))
        out.append((name, *anns))
    return root, out


def _boxes(anns):
    return [[a['bbox'][0], a['bbox'][1], a['bbox'][0] + a['bbox'][2],
             a['bbox'][1] + a['bbox'][3]] for a in anns]


def test_reid_association_beats_random(scenes):
    """Nearest-neighbour L -> R association with the tiny features: at least
    0.8 of 20 (chance is 1/5 a person), and no worse than random
    ResNet-50 features."""
    root, scene_list = scenes

    def hits(reid):
        n = 0
        for name, anns_l, anns_r in scene_list:
            f_l, f_r = get_reid_features(
                reid, _boxes(anns_l), _boxes(anns_r),
                os.path.join(root, 'data', 'kitti', 'images', name + '.png'),
                os.path.join(root, 'data', 'kitti', 'images_r', name + '.png'))
            d = np.linalg.norm(f_l[:, None, :] - f_r[None, :, :], axis=2)
            n += int(np.sum(np.argmin(d, axis=1) == np.arange(len(anns_l))))
        return n

    trained = hits(ReID(weights_path=TINY, device='cpu'))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        random = hits(ReID(weights_path=None, device='cpu'))
    assert trained >= 16 and trained >= random, (trained, random)
