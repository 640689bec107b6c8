"""Stereo batches of tests/test_torch_stereo.py and
tests/test_torch_kernels_cuda.py, and the padded-grid evaluation that the
engine's flat stereo dispatch is held to. Imports torch and the port only
(no jax), so the card's tests can use it.

`padded_grid` is the engine's stereo dispatch before its pairs went flat:
every image padded to the batch's (m_bucket, r_bucket) grid, all B x m x r
cells through the MLP, the padded right columns at -inf in the aux argmax.
"""

import math

import numpy as np
import torch

from monoloco_tpu_torch.network import engine, extract_outputs, preprocess_monstereo

KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]
KK2 = [[700., 0., 590.], [0., 700., 170.], [0., 0., 1.]]

# (left poses, right poses) a frame; 0 right poses: the first left pose
# stands in; 'tie': two copies of one right pose, whose aux logits tie.
MIXES = {
    'unequal': [(3, 5), (6, 2), (1, 4)],
    'empty_frames': [(3, 2), (0, 4), (2, 3), (0, 0)],
    'no_right_poses': [(4, 0), (2, 3)],
    'one_by_one': [(1, 1)],
    'crosses_a_tile': [(12, 11), (3, 3)],          # 141 pairs: two 128-row tiles
    'tie': [(3, 'tie'), (2, 3)],
}


def keypoints(m, rng):
    kps = rng.uniform(0, 1, size=(m, 3, 17)).astype(np.float32)
    kps[:, 0] = kps[:, 0] * 800 + 200
    kps[:, 1] = kps[:, 1] * 200 + 80
    kps[:, 2] = 0.8
    return kps


def right_of(kps, rng):
    """A right view: each pose shifted left by a disparity of 10-80 px."""
    right = kps.copy()
    right[:, 0] -= rng.uniform(10, 80, size=(len(kps), 1)).astype(np.float32)
    right[:, 0:2] += rng.normal(0, 1.0, size=right[:, 0:2].shape).astype(np.float32)
    return right


def frames(spec, seed=0):
    """(left, kks, right) lists of one batch: spec is [(L, R), ...]."""
    rng = np.random.default_rng(seed)
    left, kks, right = [], [], []
    for i, (n_l, n_r) in enumerate(spec):
        left.append(keypoints(n_l, rng))
        kks.append(KK if i % 2 == 0 else KK2)
        if n_r == 'tie':
            one = right_of(keypoints(1, rng), rng)
            right.append(np.concatenate([one, one]))
        else:
            right.append(right_of(keypoints(n_r, rng), rng) if n_r else None)
    return left, kks, right


def crowd(n_frames=64, mean=22.64, seed=0):
    """A crowd chunk: Poisson people a frame, each seen in both views."""
    counts = np.random.default_rng(seed).poisson(mean, size=n_frames)
    return frames([(int(c), int(c)) for c in counts], seed + 1)


def n_pairs(left, right):
    """The pairs the flat dispatch runs: L x R a frame, L x 1 where the
    first left pose stands in for the right view."""
    return sum(len(k) * max(0 if r is None else len(r), 1) for k, r in zip(left, right))


def _to_host(dic):
    return {k: (tuple(t.cpu().numpy() for t in v) if k == 'yaw' else v.cpu().numpy())
            for k, v in dic.items()}


def padded_grid(net, left, kks, right):
    """Per-image output dicts (None for an image without poses) of the
    padded-grid evaluation of one batch on `net`'s weights and routing."""
    counts = [len(k) for k in left]
    counts_r = [0 if r is None else len(r) for r in right]
    b = engine._bucket(len(left), minimum=1)
    m = engine._bucket(max(max(counts), 1))
    r = engine._bucket(max(max(counts_r), 1))
    kps = np.zeros((b, m, 3, 17), np.float32)
    kps_r = np.zeros((b, r, 3, 17), np.float32)
    r_mask = np.zeros((b, r), bool)
    kk = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    for i in range(len(left)):
        kps[i, :counts[i]] = left[i]
        kk[i] = kks[i]
        if counts_r[i]:
            kps_r[i, :counts_r[i]] = right[i]
            r_mask[i, :counts_r[i]] = True
        elif counts[i]:
            kps_r[i, 0] = kps[i, 0]
            r_mask[i, 0] = True
    dev = net.device
    with torch.inference_mode():
        inputs, _ = preprocess_monstereo(*(torch.from_numpy(a).to(dev) for a in (kps, kps_r, kk)))
        raw = engine._mlp_forward(net.mlp_weights, inputs.reshape(b * m * r, -1), 'loco')
        out4 = raw.reshape(b, m, r, -1)
        r_mask = torch.from_numpy(r_mask).to(dev)
        aux = torch.where(r_mask[:, None, :], out4[..., -1], -math.inf)
        best = torch.argmax(aux, dim=2)
        selected = torch.take_along_dim(out4, best[:, :, None, None], dim=2)[:, :, 0]
        dic = extract_outputs(selected.reshape(b * m, -1))
        dic['aux_idx'] = best.reshape(-1)
        dic = _to_host(dic)
    outs = []
    for i, n in enumerate(counts):
        sl = slice(i * m, i * m + n)
        outs.append({k: (v[0][sl], v[1][sl]) if k == 'yaw' else v[sl] for k, v in dic.items()}
                    if n else None)
    return outs


def assert_same(outs, refs, exact, tol=1e-5):
    """Every real left pose's outputs and `aux_idx` of two batches: equal bit
    for bit, or within tol with `aux_idx` equal."""
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert (out is None) == (ref is None)
        if out is None:
            continue
        assert set(out) == set(ref) | {'epi'}, (sorted(out), sorted(ref))
        np.testing.assert_array_equal(out['aux_idx'], ref['aux_idx'])
        for key in ref:
            for a, b in zip(*((o[key] if key == 'yaw' else (o[key],)) for o in (out, ref))):
                if exact:
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=key)
