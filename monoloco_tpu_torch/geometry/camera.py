"""Camera geometry on torch tensors (f32), batched over leading dims.

Counterpart of `monoloco_tpu/geometry/camera.py`: `pixel_to_camera`,
`project_points`, `get_keypoints`, `xyz_from_distance`,
`back_correct_angles` and the batched `to_cartesian` on tensors; the host
helpers `transform_kp` (the keypoint-warp ablations) and `open_image`; and,
from `geometry/host.py`, the scalar helpers `correct_angle`, `to_spherical`,
`project_3d` and `to_cartesian`'s list variant. The JAX package pins
HIGHEST precision on the 3x3 products; here TF32 is off process wide
(utils/precision.py), so `torch.matmul` is full f32 on the card too.
"""

import math

import numpy as np
import torch

from ..utils import precision as _precision  # noqa: F401  (pins TF32 off)
from ..utils.image import read_png_rgb
from .host import np_get_keypoints
from .host import correct_angle, project_3d, to_spherical  # noqa: F401  (the JAX module's names)
from .host import to_cartesian as _to_cartesian_list

# COCO-17 joint indices used by the reductions below.
_HEAD_SLICE = slice(0, 5)
_SHOULDER_SLICE = slice(5, 7)
_HIP_SLICE = slice(11, 13)
_ANKLE_SLICE = slice(15, 17)


def pixel_to_camera(uv, kk, z_met):
    """Back-project pixel coordinates into camera coordinates at depth z_met.

    uv: (..., 2) pixel coordinates, or (..., 2, k) keypoint layout (x-row,
        y-row), which is transposed to (..., k, 2) first.
    kk: (..., 3, 3) intrinsics, broadcast against uv's leading dims.
    Returns (..., 3) metric coordinates: z_met * K^-1 @ [u, v, 1].
    """
    uv = torch.as_tensor(uv, dtype=torch.float32)
    kk = torch.as_tensor(kk, dtype=torch.float32, device=uv.device)
    if uv.shape[-1] != 2:
        uv = uv.transpose(-1, -2)
    ones = torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
    uv1 = torch.cat([uv, ones], dim=-1)
    # `inv` is `inv_ex` plus a check of its info that syncs with the device;
    # the factorization is the same. A singular K gives non-finite values, as
    # `jnp.linalg.inv` does in the JAX package, instead of raising.
    kk_inv = torch.linalg.inv_ex(kk).inverse
    return torch.matmul(uv1, kk_inv.transpose(-1, -2)) * z_met


def project_points(xyz, kk):
    """Project camera-frame points (..., 3) into pixel coordinates (..., 2)
    through the intrinsics kk (3, 3), or (..., 3, 3) broadcast against xyz's
    leading dims."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    kk = torch.as_tensor(kk, dtype=torch.float32, device=xyz.device)
    uvw = torch.matmul(xyz, kk.transpose(-1, -2))
    return uvw[..., 0:2] / uvw[..., 2:3]


def get_keypoints(keypoints, mode):
    """Reduce COCO-17 keypoints (m, 3, 17) to one 2D point per person (m, 2)."""
    kps = torch.as_tensor(keypoints, dtype=torch.float32)
    if kps.ndim == 2:
        kps = kps[None]
    xy = kps[:, 0:2, :]
    if mode == 'center':
        return (xy.amax(dim=2) + xy.amin(dim=2)) / 2.0
    if mode == 'bottom':
        cx = (xy[:, 0:1, :].amax(dim=2) + xy[:, 0:1, :].amin(dim=2)) / 2.0
        by = xy[:, 1:2, :].amax(dim=2)
        return torch.cat([cx, by], dim=-1)
    if mode == 'head':
        return xy[:, :, _HEAD_SLICE].mean(dim=2)
    if mode == 'shoulder':
        return xy[:, :, _SHOULDER_SLICE].mean(dim=2)
    if mode == 'hip':
        return xy[:, :, _HIP_SLICE].mean(dim=2)
    if mode == 'ankle':
        return xy[:, :, _ANKLE_SLICE].mean(dim=2)
    raise ValueError(f"unknown keypoint mode: {mode}")


_TRANSFORM_MODES = ("None", "singularity", "upper", "lower", "horizontal", "vertical",
                    "lateral", 'shoulder', 'knee', 'up', 'upside', 'falling', 'random')


def transform_kp(kps, tr_mode):
    """The paper's keypoint-warp ablations, on the host: collapse or distort
    one pose, [xs(17), ys(17), confs(17)] lists, to study which cues carry
    depth. Returns the pose itself for 'None', else [xs, ys, confs, []].
    'random' draws from its own `np.random.RandomState(6)` (the numbers of
    the JAX package's `np.random.seed(6)`, leaving the global generator
    alone). 'upper', 'lower', 'lateral' and 'upside', which the reference
    lists but never implements, raise NotImplementedError."""
    assert tr_mode in _TRANSFORM_MODES
    uu_c, vv_c = (float(v) for v in np_get_keypoints(np.asarray(kps)[None, ...], 'center')[0])

    if tr_mode == "None":
        return kps
    if tr_mode == "singularity":
        uus = [uu_c] * 17
        vvs = [vv_c] * 17
    elif tr_mode == "vertical":
        uus = [uu_c] * 17
        vvs = list(kps[1])
    elif tr_mode == 'horizontal':
        uus = list(kps[0])
        vvs = [vv_c] * 17
    elif tr_mode == 'shoulder':
        uus = list(kps[0])
        vvs = list(kps[1][:7]) + [kps[1][6]] * len(kps[1][7:])
    elif tr_mode == 'knee':
        uus = list(kps[0])
        vvs = [kps[1][14]] * len(kps[1][:13]) + list(kps[1][13:])
    elif tr_mode == 'up':
        uus = list(kps[0])
        vvs = [kp - 300 for kp in kps[1]]
    elif tr_mode == 'falling':
        uus = [kps[0][16] - kp + kps[1][16] for kp in kps[1]]
        vvs = [kps[1][16] - kp + kps[0][16] for kp in kps[0]]
    elif tr_mode == 'random':
        rng = np.random.RandomState(6)
        uus = rng.uniform(min(kps[0]), max(kps[0]), len(kps[0])).tolist()
        vvs = rng.uniform(min(kps[1]), max(kps[1]), len(kps[1])).tolist()
    else:
        raise NotImplementedError(f"transform_kp mode '{tr_mode}' has no warp")
    return [uus, vvs, kps[2], []]


def xyz_from_distance(distances, xy_centers):
    """Scale rays at z = 1 (m, 3), or one (3,), by distances, a scalar, (m,)
    or (m, 1), to points (m, 3): xyz = ray * d / sqrt(1 + x^2 + y^2). On the
    device of whichever argument is a tensor (the centers' if both are)."""
    device = next((t.device for t in (xy_centers, distances) if isinstance(t, torch.Tensor)),
                  None)
    d = torch.as_tensor(distances, dtype=torch.float32, device=device)
    c = torch.as_tensor(xy_centers, dtype=torch.float32, device=device)
    if d.ndim == 0:
        d = d[None]
    if d.ndim == 1:
        d = d[:, None]
    if c.ndim == 1:
        c = c[None]
    denom = torch.sqrt(1.0 + c[:, 0:1] ** 2 + c[:, 1:2] ** 2)
    return c * d / denom


def back_correct_angles(yaws, xyz):
    """Allocentric -> egocentric yaw. yaws (m, 1), xyz (m, 3) -> (m, 1)."""
    corr = torch.atan2(xyz[:, 0], xyz[:, 2])[:, None]
    out = yaws + corr
    out = torch.where(out > math.pi, out - 2 * math.pi, out)
    out = torch.where(out < -math.pi, out + 2 * math.pi, out)
    return out


def to_cartesian(rtp, mode=None):
    """Network outputs (m, 3) laid out [theta, psi, r] -> x = r sin(psi)
    cos(theta) (mode 'x') or y = r cos(psi) (mode 'y'), as (m, 1); without
    a mode, one point [r, theta, psi] -> [x, y, z] on Python floats."""
    if mode is None:
        return _to_cartesian_list(rtp)
    t, p, r = rtp[:, 0], rtp[:, 1], rtp[:, 2]
    if mode == 'x':
        return (r * torch.sin(p) * torch.cos(t))[:, None]
    if mode == 'y':
        return (r * torch.cos(p))[:, None]
    raise ValueError(f"unknown mode: {mode}")


def open_image(path_image):
    """The image file as (h, w, 3) uint8 RGB, equal to `np.asarray` of the
    JAX package's `open_image` (a Pillow image). PNGs are decoded by
    `utils/image.py` without Pillow (the card's machine has none); other
    files go through Pillow, and without it this raises ImportError naming
    Pillow."""
    return read_png_rgb(path_image)
