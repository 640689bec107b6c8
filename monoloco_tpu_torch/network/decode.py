"""Output decoding: raw network channels -> physical quantities (torch).

Counterpart of `monoloco_tpu/network/decode.py`. Channel layout of the raw
MonoLoco++/MonStereo outputs (m, 9|10): 0 theta, 1 psi, 2 d mean,
3 log-spread, 4-6 h/w/l, 7-8 sin/cos of the allocentric yaw, 9 stereo-aux
logit. Label layout (m, 10|11), which training slices per task: 0 theta,
1 psi, 2 z, 3 d, 4-6 h/w/l, 7-8 sin/cos, 9 yaw, 10 stereo-match flag.
"""

import torch

from ..geometry import to_cartesian, back_correct_angles

_TASK_SLICES = {
    'x': (0, 1), 'y': (1, 2), 'd': (2, 4), 'h': (4, 5), 'w': (5, 6),
    'l': (6, 7), 'ori': (7, 9), 'aux': (9, 10),
}
_LABEL_SLICES = {
    'x': (0, 1), 'y': (1, 2), 'z': (2, 3), 'd': (3, 4), 'h': (4, 5),
    'w': (5, 6), 'l': (6, 7), 'ori': (7, 9), 'aux': (10, 11),
}


def unnormalize_bi(loc):
    """(..., 2) [mu, log-spread] -> absolute Laplace spread b = exp(b_hat) * mu,
    (..., 1)."""
    return torch.exp(loc[..., 1:2]) * loc[..., 0:1]


def laplace_uniforms(n_samples, m, device, seed=1):
    """The uniforms of `laplace_sampling`: (n_samples, m) f32 in [-0.5 +
    1e-7, 0.5), from a torch.Generator on `device` seeded with `seed` on
    every call (the JAX package reseeds PRNGKey(1) on every call, so every
    call draws the same uniforms; torch cannot reproduce JAX's stream)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = -0.5 + 1e-7
    u = torch.rand((n_samples, m), generator=gen, device=device)
    return torch.clamp(lo + u * (0.5 - lo), min=lo)


def laplace_sampling(outputs, n_samples, seed=1, u=None):
    """Sample Laplace(mu=outputs[..., 0], b=|outputs[..., 1]|): (..., m, 2)
    -> (..., n_samples, m). `u` (n_samples, m) are the uniforms, shared by
    every leading index; without it they come from `laplace_uniforms`."""
    outputs = outputs.float()
    mu, bi = outputs[..., 0], torch.abs(outputs[..., 1])
    if u is None:
        u = laplace_uniforms(n_samples, mu.shape[-1], outputs.device, seed)
    return (mu[..., None, :]
            - bi[..., None, :] * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u)))


def extract_outputs(outputs, tasks=()):
    """With `tasks` (a tuple), the ordered list of each task's raw channel
    slice (training). Without, decode raw outputs into xyzd, d, bi, yaw
    (alpha, ry), h/w/l, ori and, for 10-channel outputs, the sigmoid of aux;
    z is clamped at 0 where d^2 < x^2 + y^2, as in the JAX package."""
    outputs = outputs.float()
    if len(tasks) >= 1:
        assert isinstance(tasks, tuple), "tasks need to be a tuple"
        return [outputs[:, slice(*_TASK_SLICES[t])] for t in tasks]
    dic_out = {k: outputs[:, slice(*s)] for k, s in _TASK_SLICES.items()
               if k != 'aux' or outputs.shape[1] == 10}
    bi = unnormalize_bi(dic_out['d'])

    x = to_cartesian(outputs[:, 0:3], mode='x')
    y = to_cartesian(outputs[:, 0:3], mode='y')
    d = dic_out['d'][:, 0:1]
    z = torch.sqrt(torch.clamp(d ** 2 - x ** 2 - y ** 2, min=0.0))
    xyzd = torch.cat([x, y, z, d], dim=1)

    yaw_pred = torch.atan2(dic_out['ori'][:, 0:1], dic_out['ori'][:, 1:2])
    yaw_orig = back_correct_angles(yaw_pred, xyzd[:, 0:3])

    out = {
        'xyzd': xyzd, 'd': d, 'bi': bi,
        'h': dic_out['h'], 'w': dic_out['w'], 'l': dic_out['l'],
        'ori': dic_out['ori'], 'yaw': (yaw_pred, yaw_orig),
    }
    if outputs.shape[1] == 10:
        out['aux'] = torch.sigmoid(dic_out['aux'])
    return out


def extract_outputs_mono(outputs):
    """Decoding for the monoloco_p variant: direct xyz + [z, log-spread]."""
    outputs = outputs.float()
    raw = {'xyz': outputs[:, 0:3], 'zb': outputs[:, 2:4],
           'h': outputs[:, 4:5], 'w': outputs[:, 5:6], 'l': outputs[:, 6:7],
           'ori': outputs[:, 7:9]}
    bi = unnormalize_bi(raw['zb'])
    dd = torch.linalg.vector_norm(raw['xyz'], dim=1, keepdim=True)
    xyzd = torch.cat([raw['xyz'], dd], dim=1)
    yaw_pred = torch.atan2(raw['ori'][:, 0:1], raw['ori'][:, 1:2])
    yaw_orig = back_correct_angles(yaw_pred, xyzd[:, 0:3])
    return {**raw, 'xyzd': xyzd, 'd': dd, 'bi': bi, 'yaw': (yaw_pred, yaw_orig)}


def extract_labels(labels, tasks=None):
    """Slice label channels per task: a dict, or with `tasks` (a tuple) the
    ordered list."""
    dic = {k: labels[:, slice(*s)] for k, s in _LABEL_SLICES.items()
           if s[1] <= labels.shape[1]}
    if tasks is not None:
        assert isinstance(tasks, tuple), "tasks need to be a tuple"
        return [dic[t] for t in tasks]
    return dic


def extract_labels_aux(labels, tasks=None):
    """The aux-only label view: column 0 is the flag."""
    dic = {'aux': labels[:, 0:1]}
    if tasks is not None:
        assert isinstance(tasks, tuple), "tasks need to be a tuple"
        return [dic[t] for t in tasks]
    return dic


def cluster_outputs(outputs, clusters):
    """Reshape flat all-vs-all stereo outputs (m*r, c) -> (m, r, c)."""
    outputs = torch.as_tensor(outputs)
    if clusters == 0:
        clusters = max(1, round(outputs.shape[0] / 2))
    assert outputs.shape[0] % clusters == 0, "Unexpected number of inputs"
    return outputs.reshape(-1, clusters, outputs.shape[1])


def filter_outputs(outputs):
    """Keep, per left pose, the right pairing with the largest auxiliary
    score, the first one where several tie (as `jnp.argmax`). Returns ((m,
    c) best rows, (m, r) bool mask of the rows that reach the maximum)."""
    val = outputs[:, :, -1]
    best = torch.argmax(val, dim=1)
    mask = val >= val.amax(dim=1, keepdim=True)
    selected = torch.take_along_dim(outputs, best[:, None, None], dim=1)[:, 0, :]
    return selected, mask
