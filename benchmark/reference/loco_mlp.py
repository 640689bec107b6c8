"""The plain reference of MonoLoco++ and MonStereo, and their weights:
what each frame's outputs should be, in plain PyTorch, float32 with TF32
off. A configuration names this module as its `reference`.

It follows the published networks (vita-epfl/monoloco
`monoloco/network/architectures.py`, `net.py`, `process.py`) and imports
nothing of the program. The weights are the benchmark's own, unfolded:
Linear -> BatchNorm (running statistics) -> ReLU, three residual stages,
`w2`, the aux head on its output, `w3` -> BatchNorm -> ReLU -> the final
head. Per frame:

- keypoints (u, v) back-projected through K^-1 at z = 10 m, the x and y of
  the 17 joints as 34 inputs;
- stereo: every left pose against every right pose of its frame, the row
  [left, left - right] (68 inputs); the right pose kept for a left pose is
  the one with the largest aux logit, the first where several tie;
- the decode: x = d sin(psi) cos(theta), y = d cos(psi), z = sqrt(max(d^2 -
  x^2 - y^2, 0)), b = exp(log-spread) d, yaw = atan2(sin, cos), the
  egocentric yaw yaw + atan2(x, z) wrapped to [-pi, pi], aux = sigmoid;
- MC dropout (mono): `n_dropout` passes with dropout after every ReLU,
  `where(keep, h / (1 - p), 0)`, each pass's (d, b) giving 100 Laplace
  samples, the std (ddof 1) over all of them. The keep-masks and uniforms
  are drawn as the engine documents its draws (`network/engine.py`
  `draw_mc`): torch.Generators on the device seeded 0 and 1 afresh on
  every dispatch, masks (n_dropout, bucket, H) site by site and uniforms
  (100, bucket) in [-0.5 + 1e-7, 0.5), a frame's detection i taking row i,
  where `bucket` is the power of two (at least 4) that holds the chunk's
  largest frame. The draws are worked out here again from that rule.

`mlp` selects the arithmetic of the products. 'f32' is the reference.
'bf16' is the arithmetic a bfloat16 cell states: BN folded into the
Linears, every product on bfloat16-rounded operands with float32 sums, the
residual float32. 'tf32' (TF32 on) and 'int4' (BN folded, every H x H layer
on per-row int4 activations and per-column int4 weights, the input
projection and heads on bfloat16 operands, as the int8 kernel lays out its
int8) are controls, one step below a cell's precision.
"""

import contextlib
import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
N_SAMPLES = 100
Z_BACKPROJECT = 10.0


# --- the network ------------------------------------------------------------

def _bn(x, p, s):
    return (x - s['mean']) * torch.rsqrt(s['var'] + BN_EPS) * p['scale'] + p['bias']


def _stage(tree, i):
    return {k: _stage(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward(params, bn_state, x, drop=None):
    """The unfolded net on rows x (..., in) -> (..., out) [fin..., aux];
    `drop(h)` follows each ReLU (MC dropout) when given."""
    act = torch.relu if drop is None else (lambda h: drop(torch.relu(h)))

    def dense(p, a):
        return a @ p['w'] + p['b']

    y = act(_bn(dense(params['w1'], x), params['bn1'], bn_state['bn1']))
    for i in range(params['stages']['w1']['w'].shape[0]):
        p, s = _stage(params['stages'], i), _stage(bn_state['stages'], i)
        h = act(_bn(dense(p['w1'], y), p['bn1'], s['bn1']))
        h = act(_bn(dense(p['w2'], h), p['bn2'], s['bn2']))
        y = y + h
    y2 = dense(params['w2'], y)
    aux = dense(params['w_aux'], y2)
    y3 = act(_bn(dense(params['w3'], y2), params['bn3'], bn_state['bn3']))
    return torch.cat([dense(params['w_fin'], y3), aux], dim=-1)


def _fold(lin, bn, st):
    scale = bn['scale'] * torch.rsqrt(st['var'] + BN_EPS)
    return {'w': lin['w'] * scale[..., None, :], 'b': (lin['b'] - st['mean']) * scale + bn['bias']}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _quant_int4(t, dim):
    """t rounded to 15 levels along `dim` (scale max|t| / 7), as values."""
    amax = torch.clamp(t.abs().amax(dim=dim, keepdim=True), min=1e-8)
    return torch.clamp(torch.round(t * (7.0 / amax)), -7, 7) * (amax / 7.0)


def forward_folded(params, bn_state, x, outer, inner):
    """The net with BN folded into the preceding Linear: `outer(a, layer)`
    is the input projection and the heads, `inner(a, layer)` each H x H
    layer (bias included); the residual stays float32."""
    p, s = params, bn_state
    y = torch.relu(outer(x, _fold(p['w1'], p['bn1'], s['bn1'])))
    for i in range(p['stages']['w1']['w'].shape[0]):
        ps, ss = _stage(p['stages'], i), _stage(s['stages'], i)
        h = torch.relu(inner(y, _fold(ps['w1'], ps['bn1'], ss['bn1'])))
        h = torch.relu(inner(h, _fold(ps['w2'], ps['bn2'], ss['bn2'])))
        y = y + h
    y2 = inner(y, p['w2'])
    aux = outer(y2, p['w_aux'])
    y3 = torch.relu(inner(y2, _fold(p['w3'], p['bn3'], s['bn3'])))
    return torch.cat([outer(y3, p['w_fin']), aux], dim=-1)


def _bf16_dense(a, lin):
    """bfloat16 operands, float32 sums."""
    return _bf16(a) @ _bf16(lin['w']) + lin['b']


def _int4_dense(a, lin):
    """Per-row int4 activations times per-column int4 weights, f32 sums."""
    return _quant_int4(a, -1) @ _quant_int4(lin['w'], 0) + lin['b']


@contextlib.contextmanager
def _tf32(on):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mlp(weights, x, mode='f32'):
    """The net on rows x under `mode` ('f32', 'tf32', 'bf16', 'int4')."""
    params, bn_state = weights
    if mode == 'int4':
        return forward_folded(params, bn_state, x, _bf16_dense, _int4_dense)
    if mode == 'bf16':
        return forward_folded(params, bn_state, x, _bf16_dense, _bf16_dense)
    with _tf32(mode == 'tf32'):
        return forward(params, bn_state, x)


# --- the weights ------------------------------------------------------------
# A configuration's weights, made on the device from the seed.
#
# One `torch.rand` call on a generator seeded with the run's seed fills every
# Linear (uniform in +-1/sqrt(fan_in), nn.Linear's default) and every
# BatchNorm's scale (0.5..1.5) and shift (-0.25..0.25). The BatchNorms'
# running statistics are then set, layer by layer, to the mean and the
# unbiased variance of their inputs over a calibration batch of the traffic's
# own rows, as training leaves them. Last, each output channel of the two
# heads is scaled and shifted so that over the same batch it has the
# configuration's `output_mean` and `output_std` (a plausible pedestrian:
# theta = psi = pi/2, d = 15 m, ...): a trained net's outputs spread so, and
# the decode's square root and arctangents stay away from their singular
# points.
#
# The trees have the program's checkpoint layout (`w1`, `bn1`, `stages`,
# `w2`, `w3`, `bn3`, `w_aux`, `w_fin`; weights (in, out), stages stacked on a
# leading axis), which is the published net's state_dict transposed.
def _shapes(cfg):
    i, h, o, s = cfg['input_size'], cfg['linear_size'], cfg['output_size'], cfg['num_stage']
    lin = {'w1': (i, h), 'w2': (h, h), 'w3': (h, h), 'w_aux': (h, 1), 'w_fin': (h, o - 1)}
    return lin, h, s


def make_weights(cfg, seed, device, calib_x):
    """(params, bn_state) of the configuration `cfg` on `device`, from
    `seed`; `calib_x` (rows, input_size) sets the BN running statistics."""
    lin, h, s = _shapes(cfg)
    stage_lin = {'w1': (s, h, h), 'w2': (s, h, h)}
    sizes = ([math.prod(v) + v[-1] for v in lin.values()]
             + [math.prod(v) + s * h for v in stage_lin.values()]
             + [2 * h, 2 * h] + [2 * s * h, 2 * s * h])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    parts = iter(torch.split(flat, sizes))

    def linear(shape):
        chunk = next(parts)
        bound = 1.0 / math.sqrt(shape[-2])
        w = (chunk[:math.prod(shape)].reshape(shape) * 2 - 1) * bound
        b = (chunk[math.prod(shape):].reshape(shape[:-2] + shape[-1:]) * 2 - 1) * bound
        return {'w': w.contiguous(), 'b': b.contiguous()}

    def bn(shape):
        u = next(parts).reshape((2,) + shape)
        return {'scale': 0.5 + u[0], 'bias': (u[1] - 0.5) * 0.5}

    params = {k: linear(v) for k, v in lin.items()}
    params['stages'] = {k: linear(v) for k, v in stage_lin.items()}
    params['bn1'], params['bn3'] = bn((h,)), bn((h,))
    stage_bn = bn((s, h)), bn((s, h))
    params['stages']['bn1'], params['stages']['bn2'] = stage_bn
    bn_state, y2, y3 = _calibrated_bn(params, calib_x, s)
    mean = torch.tensor(cfg['output_mean'], dtype=torch.float32, device=device)
    std = torch.tensor(cfg['output_std'], dtype=torch.float32, device=device)
    for name, feats, cols in (('w_fin', y3, slice(0, -1)), ('w_aux', y2, slice(-1, None))):
        out = feats @ params[name]['w']
        scale = std[cols] / out.std(0)
        params[name]['w'] = params[name]['w'] * scale
        params[name]['b'] = mean[cols] - out.mean(0) * scale
    return params, bn_state


def _calibrated_bn(params, x, s):
    """Running statistics of every BN: the batch mean and unbiased variance
    of its input on x, each layer normalized by the statistics set before it.
    Returns (bn_state, the heads' inputs y2 and y3 on x)."""
    def stats(a):
        return {'mean': a.mean(0), 'var': a.var(0, unbiased=True)}

    def dense_bn_relu(lin, bn, a):
        a = a @ lin['w'] + lin['b']
        st = stats(a)
        return torch.relu(_bn(a, bn, st)), st

    with torch.no_grad():
        y, bn1 = dense_bn_relu(params['w1'], params['bn1'], x)
        stages = {'bn1': [], 'bn2': []}
        for i in range(s):
            p = _stage(params['stages'], i)
            hh, st1 = dense_bn_relu(p['w1'], p['bn1'], y)
            hh, st2 = dense_bn_relu(p['w2'], p['bn2'], hh)
            y = y + hh
            stages['bn1'].append(st1)
            stages['bn2'].append(st2)
        y2 = y @ params['w2']['w'] + params['w2']['b']
        y3, bn3 = dense_bn_relu(params['w3'], params['bn3'], y2)
    return {'bn1': bn1, 'bn3': bn3,
            'stages': {k: {f: torch.stack([st[f] for st in v]) for f in ('mean', 'var')}
                       for k, v in stages.items()}}, y2, y3


def clone(tree):
    """A deep copy of a tree of tensors (what the program is handed)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


# --- inputs and outputs -----------------------------------------------------

def normalize(kps, kk):
    """kps (n, 3, 17) pixels and kk (n, 3, 3), float tensors on one device ->
    (n, 34): the joints' x, y at z = 10 m through K^-1 (inverted in float64)."""
    kinv = torch.linalg.inv(kk.double()).float()
    uv1 = torch.stack([kps[:, 0], kps[:, 1], torch.ones_like(kps[:, 0])], dim=-1)  # (n,17,3)
    xyz = torch.einsum('njk,nik->nji', uv1, kinv) * Z_BACKPROJECT
    return xyz[..., 0:2].reshape(kps.shape[0], 34)


def decode(raw):
    """Raw outputs (n, 9|10) -> dict of (n,) float64 numpy arrays."""
    raw = raw.double()
    th, ps, d = raw[:, 0], raw[:, 1], raw[:, 2]
    x = d * torch.sin(ps) * torch.cos(th)
    y = d * torch.cos(ps)
    z = torch.sqrt(torch.clamp(d ** 2 - x ** 2 - y ** 2, min=0.0))
    yaw = torch.atan2(raw[:, 7], raw[:, 8])
    ego = yaw + torch.atan2(x, z)
    ego = torch.where(ego > math.pi, ego - 2 * math.pi, ego)
    ego = torch.where(ego < -math.pi, ego + 2 * math.pi, ego)
    out = {'x': x, 'y': y, 'z': z, 'd': d, 'bi': torch.exp(raw[:, 3]) * d,
           'h': raw[:, 4], 'w': raw[:, 5], 'l': raw[:, 6],
           'sin': raw[:, 7], 'cos': raw[:, 8], 'yaw': yaw, 'yaw_ego': ego}
    if raw.shape[1] == 10:
        out['aux'] = torch.sigmoid(raw[:, 9])
    return {k: v.cpu().numpy() for k, v in out.items()}


def bucket(n, minimum=4):
    """The engine's detection bucket: the least power of two >= n, at least
    `minimum`."""
    b = minimum
    while b < n:
        b *= 2
    return b


def cat_frames(frames, device):
    return torch.from_numpy(np.concatenate(frames, axis=0)).to(device)


def kk_rows(kks, counts, device):
    return torch.from_numpy(np.repeat(np.stack(kks), counts, axis=0)).to(device)


def calibration_rows(cfg, chunk, device):
    """The rows of one chunk as the network sees them, the batch
    `make_weights` sets the BN statistics and output spreads from; stereo
    pairs each left pose with the right pose at its place in the list."""
    left = normalize(cat_frames(chunk['left'], device), kk_rows(chunk['kk'], chunk['counts'],
                                                                  device))
    if cfg['mode'] != 'stereo':
        return left
    right = normalize(cat_frames(chunk['right'], device),
                      kk_rows(chunk['kk'], chunk['counts_r'], device))
    n = min(left.shape[0], right.shape[0])
    return torch.cat([left[:n], left[:n] - right[:n]], dim=1)


# --- per chunk --------------------------------------------------------------

def mono_chunk(weights, chunk, device, mode='f32'):
    """Every detection of a mono chunk: the decoded dict over the chunk's
    detections in frame order."""
    x = normalize(cat_frames(chunk['left'], device), kk_rows(chunk['kk'], chunk['counts'],
                                                               device))
    return decode(mlp(weights, x, mode))


def stereo_chunk(weights, chunk, device, mode='f32'):
    """Every left detection of a stereo chunk against every right one of its
    frame. Returns (raw (sum L, Rmax, 10) float64 numpy, the raw outputs of
    each left pose with each right pose, NaN past R; best (sum L,) the
    reference's choice)."""
    counts, counts_r = np.asarray(chunk['counts']), np.asarray(chunk['counts_r'])
    inp_l = normalize(cat_frames(chunk['left'], device),
                      kk_rows(chunk['kk'], counts, device))
    inp_r = normalize(cat_frames(chunk['right'], device),
                      kk_rows(chunk['kk'], counts_r, device))
    # Pair indices: for each frame, each left pose i with each right pose j.
    off_r = np.concatenate([[0], np.cumsum(counts_r)[:-1]])
    rep = np.repeat(counts_r, counts)                      # R of each left pose
    left_idx = np.repeat(np.arange(counts.sum()), rep)
    frame_of_left = np.repeat(np.arange(len(counts)), counts)
    j_in = np.concatenate([np.arange(r) for r in rep])
    right_idx = off_r[frame_of_left][left_idx] + j_in
    li = torch.from_numpy(left_idx).to(device)
    ri = torch.from_numpy(right_idx).to(device)
    rows = torch.cat([inp_l[li], inp_l[li] - inp_r[ri]], dim=1)
    raw = mlp(weights, rows, mode).double().cpu().numpy()
    r_max = int(counts_r.max())
    grid = np.full((counts.sum(), r_max, raw.shape[1]), np.nan)
    grid[left_idx, j_in] = raw
    aux = np.where(np.isnan(grid[..., -1]), -np.inf, grid[..., -1])
    return grid, np.argmax(aux, axis=1)


def mc_draws(n_dropout, rows, hidden, n_sites, p_dropout, device):
    """The engine's MC draws for a dispatch over a `rows` bucket: n_sites
    keep-masks (n_dropout, rows, hidden) and the uniforms (100, rows)."""
    gen = torch.Generator(device=device).manual_seed(0)
    masks = [torch.rand((n_dropout, rows, hidden), generator=gen, device=device)
             < 1.0 - p_dropout for _ in range(n_sites)]
    gen = torch.Generator(device=device).manual_seed(1)
    lo = -0.5 + 1e-7
    u = torch.rand((N_SAMPLES, rows), generator=gen, device=device)
    return masks, torch.clamp(lo + u * (0.5 - lo), min=lo)


def mc_epistemic(weights, chunk, device, n_dropout, p_dropout, mode='f32'):
    """The MC-dropout std of every detection of a mono chunk, (sum L,)
    float64 numpy, in frame order."""
    params, _ = weights
    hidden = params['w1']['w'].shape[1]
    n_sites = 2 * params['stages']['w1']['w'].shape[0] + 2
    counts = np.asarray(chunk['counts'])
    rows = bucket(int(counts.max()))
    masks, u = mc_draws(n_dropout, rows, hidden, n_sites, p_dropout, device)
    pos = torch.from_numpy(np.concatenate([np.arange(m) for m in counts])).to(device)
    keep = [mk[:, pos] for mk in masks]                    # (n, sum L, H) each
    sites = iter(keep)

    def drop(h):
        return torch.where(next(sites), h / (1.0 - p_dropout), 0.0)

    x = normalize(cat_frames(chunk['left'], device), kk_rows(chunk['kk'], counts, device))
    params, bn_state = weights
    with _tf32(mode == 'tf32'):
        out = forward(params, bn_state, x.expand(n_dropout, *x.shape), drop=drop)
    mu = out[..., 2]                                       # (n, sum L)
    b = torch.abs(torch.exp(out[..., 3]) * out[..., 2])
    uu = u[:, pos]                                         # (S, sum L)
    samples = mu[:, None] - b[:, None] * torch.sign(uu) * torch.log1p(-2.0 * torch.abs(uu))
    return torch.std(samples.reshape(-1, samples.shape[-1]), dim=0, correction=1).double() \
        .cpu().numpy()
