"""Camera geometry on torch tensors (f32), batched over leading dims.

Counterpart of `monoloco_tpu/geometry/camera.py`: `pixel_to_camera`,
`get_keypoints`, `back_correct_angles` and the batched `to_cartesian`. The JAX
package pins HIGHEST precision on the 3x3 products; here TF32 is off process
wide (utils/precision.py), so `torch.matmul` is full f32 on the card too.
"""

import math

import torch

from ..utils import precision as _precision  # noqa: F401  (pins TF32 off)

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
    kk_inv = torch.linalg.inv(kk)
    return torch.matmul(uv1, kk_inv.transpose(-1, -2)) * z_met


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


def back_correct_angles(yaws, xyz):
    """Allocentric -> egocentric yaw. yaws (m, 1), xyz (m, 3) -> (m, 1)."""
    corr = torch.atan2(xyz[:, 0], xyz[:, 2])[:, None]
    out = yaws + corr
    out = torch.where(out > math.pi, out - 2 * math.pi, out)
    out = torch.where(out < -math.pi, out + 2 * math.pi, out)
    return out


def to_cartesian(rtp, mode):
    """Network outputs (m, 3) laid out [theta, psi, r] -> x = r sin(psi)
    cos(theta) (mode 'x') or y = r cos(psi) (mode 'y'), as (m, 1)."""
    t, p, r = rtp[:, 0], rtp[:, 1], rtp[:, 2]
    if mode == 'x':
        return (r * torch.sin(p) * torch.cos(t))[:, None]
    if mode == 'y':
        return (r * torch.cos(p))[:, None]
    raise ValueError(f"unknown mode: {mode}")
