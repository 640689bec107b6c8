"""Train the tiny synthetic-texture ReID embedding on one CUDA card.

Counterpart of the JAX package's `tools/train_tiny_reid.py`. Without the
reference's Market-1501 ResNet-50 the stereo `reid` association baseline
runs on random features; this trains the ~25k-parameter tiny embedding
(`eval/reid_baseline.py` `tiny_reid_features`) on crops drawn with the
per-identity texture generator of the synthetic KITTI scenes
(`tools/make_synthetic_kitti.py` `identity_texture`), so that the same
identity's left and right crops embed close and different identities far.

The same recipe as the JAX tool: 64 identities x 8 crops from
`numpy.random.RandomState(0)` (each crop the identity's texture at a
jittered size, nearest-neighbour resized to 64 x 32, pixel noise, ImageNet
normalization); the net's init from `torch.Generator` seed 0 and a 64 x 64
identity head from seed 7 (x 0.1); softmax cross-entropy of the features
(L2-normalized) times the head times 10; Adam at lr 3e-3 (betas 0.9,
0.999, eps 1e-8, optax's defaults); batches of 128 drawn by
`RandomState(2)`; 240 steps (`TINY_REID_STEPS` overrides). The head is
dropped afterwards. Then the holdout check: unseen crops of the 64 seen and
32 unseen identities (`RandomState(1)`) must associate by nearest
neighbour with accuracy above 0.8, or the tool fails and writes nothing.

The output is a pickle in the format of `tests/fixture_tiny_reid.pkl`
('tiny_reid-v1': numpy params with HWIO convolutions, height, width,
meta), which the port's `ReID` and the JAX package's read.

    python -m monoloco_tpu_torch.tools.train_tiny_reid OUT.pkl [--disable-cuda]

OUT is required: the JAX tool's default is the repository's fixture. Without
a card and without `--disable-cuda` it raises (`default_device()`).
"""

import argparse
import os
import pickle
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.reid_baseline import (TINY_HEIGHT, TINY_WIDTH, _flatten, _tree_map, init_tiny_reid,
                                  tiny_reid_features)
from ..network.preprocess import IMAGENET_MEAN, IMAGENET_STD
from .make_synthetic_kitti import identity_texture

N_IDENTITIES = 64
CROPS_PER_ID = 8
BATCH = 128
LR = 3e-3
LOGIT_SCALE = 10.0
HOLDOUT_MIN_ACC = 0.8


def steps_default():
    return int(os.environ.get('TINY_REID_STEPS', '240'))


def make_crop(identity, rng):
    """One augmented (64, 32, 3) f32 crop of an identity, normalized: the
    texture at a jittered size, pasted into the crop frame by nearest
    neighbour, pixel noise (the JAX tool's `make_crop`, draw for draw)."""
    h = rng.randint(int(TINY_HEIGHT * 0.7), TINY_HEIGHT * 2)
    w = rng.randint(int(TINY_WIDTH * 0.7), TINY_WIDTH * 2)
    tex = identity_texture(identity, h, w, noise_rng=rng).astype(np.float32)
    ys = (np.arange(TINY_HEIGHT) * h / TINY_HEIGHT).astype(int)
    xs = (np.arange(TINY_WIDTH) * w / TINY_WIDTH).astype(int)
    crop = tex[ys][:, xs]
    crop += rng.randn(*crop.shape) * 8.0
    crop = np.clip(crop, 0, 255) / 255.0
    return (crop - IMAGENET_MEAN) / IMAGENET_STD


def training_set():
    """(crops (512, 64, 32, 3) f32, identities (512,)) from RandomState(0)."""
    rng = np.random.RandomState(0)
    xs = np.stack([make_crop(i, rng) for i in range(N_IDENTITIES) for _ in range(CROPS_PER_ID)])
    return xs.astype(np.float32), np.repeat(np.arange(N_IDENTITIES), CROPS_PER_ID)


def init_trainable():
    """{'net': the tiny net's init (seed 0), 'head': (64, 64) (seed 7) x 0.1}."""
    net = init_tiny_reid(torch.Generator().manual_seed(0))
    head = torch.randn((64, N_IDENTITIES), generator=torch.Generator().manual_seed(7)) * 0.1
    return {'net': net, 'head': head.float()}


def nchw(x):
    """(n, h, w, 3) numpy -> (n, 3, h, w) f32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


class TinyReIDTrainer:
    """The trainable tree on `device` and its Adam."""

    def __init__(self, trainable, device):
        self.device = torch.device(device)
        self.trainable = _tree_map(
            lambda t: torch.as_tensor(t, dtype=torch.float32).to(self.device).clone()
            .requires_grad_(True), trainable)
        self.leaves = [leaf for _, leaf in _flatten(self.trainable)]
        self.optimizer = torch.optim.Adam(self.leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8)

    def loss(self, x, y):
        """Softmax cross-entropy of the scaled feature-head logits; x (n, 3,
        64, 32), y (n,) on the device."""
        feats = tiny_reid_features(self.trainable['net'], x)
        return F.cross_entropy(feats @ self.trainable['head'] * LOGIT_SCALE, y)

    def step(self, x, y):
        """One Adam step on (x, y); the gradients stay in the leaves' .grad.
        Returns the loss before the step (a device scalar)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(x, y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, xs, ys, steps, log_every=20):
        """`steps` steps on batches of BATCH rows of (xs, ys) (numpy) drawn by
        RandomState(2); the data goes to the device once."""
        x_all = nchw(xs).to(self.device)
        y_all = torch.as_tensor(ys, dtype=torch.long, device=self.device)
        order_rng = np.random.RandomState(2)
        t0 = time.perf_counter()
        for i in range(steps):
            idx = torch.from_numpy(order_rng.randint(0, xs.shape[0], size=BATCH)).to(self.device)
            loss = self.step(x_all[idx], y_all[idx])
            if i % log_every == 0 or i == steps - 1:
                print(f'step {i}: loss {float(loss):.4f} [{time.perf_counter() - t0:.1f}s]',
                      flush=True)
        return float(loss)

    def features(self, x):
        with torch.no_grad():
            return tiny_reid_features(self.trainable['net'], nchw(x).to(self.device)).cpu().numpy()


def holdout_accuracy(trainer):
    """Nearest-neighbour association accuracy between two unseen crops each
    of the 64 seen and 32 unseen identities (RandomState(1))."""
    rng = np.random.RandomState(1)
    test_ids = list(range(N_IDENTITIES)) + list(range(5000, 5032))
    a = np.stack([make_crop(i, rng) for i in test_ids])
    b = np.stack([make_crop(i, rng) for i in test_ids])
    fa, fb = trainer.features(a), trainer.features(b)
    d = np.linalg.norm(fa[:, None, :] - fb[None, :, :], axis=2)
    return float(np.mean(np.argmin(d, axis=1) == np.arange(len(test_ids)))), len(test_ids)


def to_jax_layout(net):
    """The port's tiny-net tree (OIHW convolutions) as the fixture's numpy
    tree (HWIO), the inverse of `reid_baseline.params_from_jax`."""
    def leaf(t):
        a = t.detach().cpu().numpy().astype(np.float32)
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return _tree_map(leaf, net)


def save(path, net, steps, acc):
    blob = {'format': 'tiny_reid-v1', 'params': to_jax_layout(net),
            'height': TINY_HEIGHT, 'width': TINY_WIDTH,
            'meta': {'identities': N_IDENTITIES, 'steps': steps, 'holdout_nn_acc': acc}}
    with open(path, 'wb') as f:
        pickle.dump(blob, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('out', help='the pickle to write')
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    args = parser.parse_args(argv)
    if args.disable_cuda:
        device = torch.device('cpu')
    else:
        from ..network.engine import default_device
        device = default_device()
    steps = steps_default()
    t0 = time.perf_counter()
    xs, ys = training_set()
    trainer = TinyReIDTrainer(init_trainable(), device)
    loss = trainer.train(xs, ys, steps)
    acc, n_ids = holdout_accuracy(trainer)
    print(f'holdout nearest-neighbor accuracy: {acc:.3f} ({n_ids} identities, 32 unseen) '
          f'[{time.perf_counter() - t0:.1f}s on {device}]', flush=True)
    if not acc > HOLDOUT_MIN_ACC:
        raise SystemExit(f'tiny ReID failed to learn the texture space: holdout accuracy '
                         f'{acc:.3f} <= {HOLDOUT_MIN_ACC}')
    save(args.out, trainer.trainable['net'], steps, acc)
    print(f'saved {args.out}', flush=True)
    return {'steps': steps, 'final_loss': loss, 'holdout_nn_acc': acc,
            'wall_s': time.perf_counter() - t0, 'device': str(device)}


if __name__ == '__main__':
    main()
