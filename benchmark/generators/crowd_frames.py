"""Crowded frames of COCO-17 poses, mono or stereo, drawn from a seed.

`_project` and `make_person` are a frozen copy of the pose generator of
`monoloco_tpu_torch/tools/make_synthetic_kitti.py`: a canonical 1.77 m
skeleton projected through KITTI's K, 0.3 px of noise a coordinate, the
right view's person shifted by the baseline, so its keypoints move left by
B f / z. The copy lives here so that no change to the program moves the
yardstick. `people_keypoints` is the same arithmetic over arrays of people
and per-frame intrinsics (`tests/test_bench_generator.py` holds it to
`make_person`), so a pool of thousands of frames is made in milliseconds.

What a mix (`traffic/<name>.json`) sets, and where each number comes from
(the mix names its sources):

- people a frame: Poisson with `people_mean`, the mean of a crowded
  pedestrian dataset; the Poisson shape (people independent of one
  another) is the mix's assumption;
- cameras: `cameras`, published calibrations (fx = fy, cx, cy), one picked
  a frame; `image_width` and `baseline` of the same rig;
- people uniform over the camera's field of view across, and in depth over
  `z_min..z_max`;
- stereo: the right camera sits `baseline` to the right, so its view loses
  the people nearest the image's left edge and gains as many, on average,
  at its right edge: each person of a frame leaves with the chance p = B f
  E[1/z] / W that the baseline's strip of the view holds them, and as many
  newcomers are drawn with the same chance (binomial, each), so the right
  count is L - gone + come (at least 1).

`make_pool(traffic, seed)` returns the frames a run cycles through, in
chunks. Every chunk's counts (left, and right with how many of the left
people it keeps) come from `sizes_seed`, fixed in the mix, so every run
seed asks the same work: the same chunks, so the same buckets, each
chunk's largest frame setting its own. The run's seed orders the chunks
and each chunk's frames, picks each frame's camera and draws the people.
"""

import numpy as np

FX = FY = 721.5377
CX, CY = 609.5593, 172.854
BASELINE = 0.54

# Canonical skeleton: per-joint (dy from top of head [m], dx from center [m])
# in a 1.77m-tall person's body frame. COCO order.
_SKELETON = [
    (0.07, 0.00),   # nose
    (0.05, -0.03), (0.05, 0.03),     # eyes
    (0.08, -0.07), (0.08, 0.07),     # ears
    (0.25, -0.18), (0.25, 0.18),     # shoulders
    (0.50, -0.22), (0.50, 0.22),     # elbows
    (0.72, -0.24), (0.72, 0.24),     # wrists
    (0.80, -0.10), (0.80, 0.10),     # hips
    (1.20, -0.11), (1.20, 0.11),     # knees
    (1.65, -0.12), (1.65, 0.12),     # ankles
]
PERSON_H = 1.77
Y_TOP = -0.65


def _project(x, y, z):
    return FX * x / z + CX, FY * y / z + CY


def make_person(x, z, rng, cam_shift=0.0):
    """COCO keypoints + box for a person whose head top is at y=-0.8 (camera
    1m above ground-ish). Returns (kps_flat_51, bbox_xywh, gt_fields)."""
    y_top = -0.65
    xs, ys = [], []
    for dy, dx in _SKELETON:
        u, v = _project(x - cam_shift + dx, y_top + dy, z)
        xs.append(u + rng.randn() * 0.3)
        ys.append(v + rng.randn() * 0.3)
    confs = [0.85 + 0.1 * rng.rand() for _ in range(17)]
    flat = []
    for u, v, c in zip(xs, ys, confs):
        flat += [round(u, 2), round(v, 2), round(c, 3)]
    x1, y1 = min(xs) - 3, min(ys) - 5
    x2, y2 = max(xs) + 3, max(ys) + 5
    bbox = [x1, y1, x2 - x1, y2 - y1]
    # gt box slightly tighter
    gt_box = [min(xs) - 1, min(ys) - 3, max(xs) + 1, max(ys) + 3]
    y_center = y_top + PERSON_H / 2
    return flat, bbox, dict(box=gt_box, xyz=(x, y_center + 0.85, z))


def people_keypoints(x, z, noise, rand, kk, cam_shift=0.0):
    """`make_person`'s keypoints for n people at once: x, z (n,), noise (n,
    17, 2) standard normals (u then v, joint by joint, as `make_person`
    draws them), rand (n, 17) uniforms for the confidences, kk (n, 3, 3)
    each person's intrinsics. Returns (n, 3, 17) float32 [us, vs, confs],
    rounded as `make_person` rounds them."""
    sk = np.asarray(_SKELETON)                                   # (17, 2) dy, dx
    fx, fy = kk[:, 0, 0, None], kk[:, 1, 1, None]
    cx, cy = kk[:, 0, 2, None], kk[:, 1, 2, None]
    zz = z[:, None]
    u = fx * (x[:, None] - cam_shift + sk[None, :, 1]) / zz + cx + noise[..., 0] * 0.3
    v = fy * (Y_TOP + sk[None, :, 0]) / zz + cy + noise[..., 1] * 0.3
    c = 0.85 + 0.1 * rand
    return np.stack([np.round(u, 2), np.round(v, 2), np.round(c, 3)], axis=1).astype(np.float32)


def edge_share(traffic):
    """The chance that the baseline's strip of the view holds a person:
    B f E[1/z] / W, z uniform over `z_min..z_max`, f the cameras' mean."""
    f = float(np.mean([c[0] for c in traffic['cameras']]))
    z0, z1 = traffic['z_min'], traffic['z_max']
    inv_z = np.log(z1 / z0) / (z1 - z0)
    return traffic['baseline'] * f * inv_z / traffic['image_width']


def chunk_sizes(traffic):
    """Every chunk's counts, from `sizes_seed` alone: (left (n, F), right
    (n, F) or None, kept (n, F) or None), `kept` the left people the right
    view still holds."""
    rng = np.random.default_rng(traffic['sizes_seed'])
    shape = (traffic['pool_chunks'], traffic['chunk_frames'])
    left = np.maximum(rng.poisson(traffic['people_mean'], shape), 1)
    if traffic['views'] != 'stereo':
        return left, None, None
    p = edge_share(traffic)
    kept = left - rng.binomial(left, p)
    right = np.maximum(kept + rng.binomial(left, p), 1)
    return left, right, kept


def _intrinsics(traffic):
    kk = np.zeros((len(traffic['cameras']), 3, 3), np.float64)
    for i, (f, cx, cy) in enumerate(traffic['cameras']):
        kk[i] = [[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]
    return kk


def _place(rng, kk, traffic):
    """x, z of people seen by cameras kk (n, 3, 3): z uniform, x uniform
    over the view's width at that depth."""
    z = rng.uniform(traffic['z_min'], traffic['z_max'], len(kk))
    f, cx = kk[:, 0, 0], kk[:, 0, 2]
    x = rng.uniform(-cx / f, (traffic['image_width'] - cx) / f) * z
    return x, z


def _split(arr, counts):
    return np.split(arr, np.cumsum(counts)[:-1])


def make_pool(traffic, seed):
    """The pool of chunks a run cycles through: a list of `pool_chunks`
    chunks, each a dict with 'left' (list of (L, 3, 17) float32), 'kk' (list
    of (3, 3) float32), 'counts' (L per frame) and, for stereo traffic,
    'right' (list of (R, 3, 17)) and 'counts_r'."""
    rng = np.random.default_rng(seed)
    left_all, right_all, kept_all = chunk_sizes(traffic)
    cams = _intrinsics(traffic)
    base = traffic.get('baseline', 0.0)
    pool = []
    for c in rng.permutation(len(left_all)):
        order = rng.permutation(left_all.shape[1])
        left = left_all[c, order]
        kk = cams[rng.integers(0, len(cams), len(left))]
        n = int(left.sum())
        kk_p = np.repeat(kk, left, axis=0)
        x, z = _place(rng, kk_p, traffic)
        kps_l = people_keypoints(x, z, rng.standard_normal((n, 17, 2)), rng.random((n, 17)), kk_p)
        chunk = {'left': _split(kps_l, left), 'kk': list(kk.astype(np.float32)),
                 'counts': left.tolist()}
        if right_all is not None:
            right, kept = right_all[c, order], kept_all[c, order]
            xr, zr = [], []
            for xs, zs, kf, k, r in zip(_split(x, left), _split(z, left), kk, kept, right):
                # The right view loses the people nearest the left edge and
                # gains newcomers in the strip at its right edge.
                stay = np.argsort(xs / zs)[len(xs) - k:]
                z_new = rng.uniform(traffic['z_min'], traffic['z_max'], r - k)
                x_new = (traffic['image_width'] - kf[0, 2]) / kf[0, 0] * z_new \
                    + rng.uniform(0.0, base, r - k)
                shuffle = rng.permutation(r)
                xr.append(np.concatenate([xs[stay], x_new])[shuffle])
                zr.append(np.concatenate([zs[stay], z_new])[shuffle])
            nr = int(right.sum())
            kps_r = people_keypoints(np.concatenate(xr), np.concatenate(zr),
                                     rng.standard_normal((nr, 17, 2)), rng.random((nr, 17)),
                                     np.repeat(kk, right, axis=0), cam_shift=base)
            chunk['right'] = _split(kps_r, right)
            chunk['counts_r'] = right.tolist()
        pool.append(chunk)
    return pool
