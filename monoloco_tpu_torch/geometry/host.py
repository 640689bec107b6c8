"""Host-side (numpy) geometry reductions, copied from
`monoloco_tpu/geometry/host.py` so the port never imports the JAX package
(whose `geometry/__init__.py` pulls in jax).

Post-processing works on a handful of detections per image, so it stays in
numpy on the host; `geometry/camera.py` holds the torch twins that run on the
device inside the forward. `correct_angle`, `to_spherical`, `to_cartesian`
(its list variant) and `project_3d` are the scalar helpers of
`monoloco_tpu/geometry/camera.py` that ground-truth parsing and prep call
on Python floats.
"""

import math

import numpy as np


def np_get_keypoints(keypoints, mode):
    """(m, 3, 17) -> (m, 2). Same reductions as camera.get_keypoints."""
    kps = np.asarray(keypoints, dtype=np.float32)
    if kps.ndim == 2:
        kps = kps[None]
    xy = kps[:, 0:2, :]
    if mode == 'center':
        return (xy.max(axis=2) + xy.min(axis=2)) / 2.0
    if mode == 'bottom':
        cx = (xy[:, 0:1, :].max(axis=2) + xy[:, 0:1, :].min(axis=2)) / 2.0
        by = xy[:, 1:2, :].max(axis=2)
        return np.concatenate([cx, by], axis=-1)
    if mode == 'head':
        return xy[:, :, 0:5].mean(axis=2)
    if mode == 'shoulder':
        return xy[:, :, 5:7].mean(axis=2)
    if mode == 'hip':
        return xy[:, :, 11:13].mean(axis=2)
    if mode == 'ankle':
        return xy[:, :, 15:17].mean(axis=2)
    raise ValueError(mode)


def np_pixel_to_camera(uv, kk, z_met):
    """(..., 2) pixels -> (..., 3) camera coords at depth z_met."""
    uv = np.asarray(uv, dtype=np.float64)
    kk = np.asarray(kk, dtype=np.float64)
    if uv.shape[-1] != 2:
        uv = np.swapaxes(uv, -1, -2)
    ones = np.ones(uv.shape[:-1] + (1,))
    uv1 = np.concatenate([uv, ones], axis=-1)
    return (uv1 @ np.linalg.inv(kk).T) * z_met


def np_xyz_from_distance(distances, xy_centers):
    d = np.asarray(distances, dtype=np.float64)
    c = np.asarray(xy_centers, dtype=np.float64)
    if d.ndim == 0:
        d = d[None]
    if d.ndim == 1:
        d = d[:, None]
    if c.ndim == 1:
        c = c[None]
    denom = np.sqrt(1.0 + c[:, 0:1] ** 2 + c[:, 1:2] ** 2)
    return c * d / denom


def np_preprocess_monoloco(keypoints, kk, zero_center=False):
    """Host (numpy) twin of network.preprocess.preprocess_monoloco:
    keypoints (m, 3, 17) -> (m, 34) K^-1-normalized inputs at z=10."""
    kps = np.asarray(keypoints, dtype=np.float32)
    if kps.ndim == 2:
        kps = kps[None]
    xy1_all = np_pixel_to_camera(kps[:, 0:2, :], kk, 10)   # (m, 17, 3)
    if zero_center:
        uv_center = np_get_keypoints(kps, 'center')
        xy1_center = np_pixel_to_camera(uv_center, kk, 10)
        xy1_all = xy1_all - xy1_center[:, None, :]
    return xy1_all[:, :, 0:2].reshape(xy1_all.shape[0], -1).astype(np.float32)


def np_laplace_sampling(outputs, n_samples, seed=1):
    """Deterministic Laplace sampler: (m, 2) [mu, b] -> (n_samples, m),
    reseeded on every call like the reference's sampler."""
    outputs = np.asarray(outputs, dtype=np.float64)
    mu, bi = outputs[:, 0], np.abs(outputs[:, 1])
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5 + 1e-12, 0.5, size=(n_samples, mu.shape[0]))
    return mu - bi * np.sign(u) * np.log1p(-2.0 * np.abs(u))


def correct_angle(yaw, xyz):
    """Egocentric (rotation_y) -> allocentric (observation angle), wrapped to
    [-pi, pi]. Returns (sin(alpha), cos(alpha), alpha)."""
    correction = math.atan2(float(xyz[0]), float(xyz[2]))
    alpha = float(yaw) - correction
    if alpha > math.pi:
        alpha -= 2 * math.pi
    elif alpha < -math.pi:
        alpha += 2 * math.pi
    return math.sin(alpha), math.cos(alpha), alpha


def to_spherical(xyz):
    """Cartesian -> spherical [r, theta, psi]."""
    x, y, z = float(xyz[0]), float(xyz[1]), float(xyz[2])
    r = math.sqrt(x * x + y * y + z * z)
    theta = math.atan2(z, x)
    psi = math.acos(y / r)
    return [r, theta, psi]


def to_cartesian(rtp):
    """Spherical [r, theta, psi] -> cartesian [x, y, z], on Python floats:
    the list variant of `monoloco_tpu/geometry/camera.py`'s `to_cartesian`
    (the port's batched torch variant, `geometry.camera.to_cartesian`,
    takes network outputs laid out [theta, psi, r] and a `mode`)."""
    r, t, p = float(rtp[0]), float(rtp[1]), float(rtp[2])
    return [r * math.sin(p) * math.cos(t), r * math.cos(p), r * math.sin(p) * math.sin(t)]


def project_3d(box_obj, kk):
    """Project a 3D box (a nuScenes Box: `center`, `wlh`) into an image-plane
    2D box [x1, y1, x2, y2] through its two central corners at the centre's
    depth."""
    xc, yc, zc = box_obj.center
    ww, _, hh = box_obj.wlh
    corners = np.array([[xc - ww / 2, yc - hh / 2, zc],
                        [xc + ww / 2, yc + hh / 2, zc]])
    kk = np.asarray(kk, dtype=np.float64)
    box_2d = []
    for xyz in corners:
        uvw = kk @ xyz
        box_2d.append(float(uvw[0] / uvw[2]))
        box_2d.append(float(uvw[1] / uvw[2]))
    return box_2d
