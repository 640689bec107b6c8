"""Geometric distance baseline: depth from a known human-segment height. A
host copy of `monoloco_tpu/eval/geom_baseline.py`.

`compute_depth` solves the least squares of the shoulder and hip rays with
an average torso height of 0.48 m; `geometric_coordinates` solves every
detection's system in one batched normal-equation solve;
`geometric_baseline` (`eval --geometric`) gathers the segment-height and
geometric-distance error statistics of a joints file.
"""

import json
import math
from collections import defaultdict

import numpy as np

from ..geometry.host import np_get_keypoints, np_pixel_to_camera

AVERAGE_Y = 0.48
CLUSTERS = ['10', '20', '30', 'all']


def _solve_depths(x1, y1, x2, y2, cc):
    """Batched least-squares depths: one (4x3) system per person, solved with
    regularized normal equations (the single implementation both the scalar
    and batched entry points share). Inputs are (m,) arrays; cc scalar or (m,).
    """
    x1, y1 = np.atleast_1d(np.asarray(x1, np.float64)), np.atleast_1d(np.asarray(y1, np.float64))
    x2, y2 = np.atleast_1d(np.asarray(x2, np.float64)), np.atleast_1d(np.asarray(y2, np.float64))
    m = x1.shape[0]
    cc = np.broadcast_to(np.asarray(cc, np.float64), (m,))
    xx = (x1 + x2) / 2
    zeros, ones = np.zeros(m), np.ones(m)
    A = np.stack([
        np.stack([y1, zeros, -xx], axis=1),
        np.stack([zeros, -y1, ones], axis=1),
        np.stack([y2, zeros, -xx], axis=1),
        np.stack([zeros, -y2, ones], axis=1),
    ], axis=1)                                  # (m, 4, 3)
    rhs = np.stack([cc * xx, -cc, zeros, zeros], axis=1)
    AtA = np.einsum('mij,mik->mjk', A, A)
    Atb = np.einsum('mij,mi->mj', A, rhs)
    sols = np.linalg.solve(AtA + 1e-12 * np.eye(3)[None], Atb[..., None])[..., 0]
    return np.abs(sols[:, 1])


def compute_depth(xyz_norm_1, xyz_norm_2, average_y, mode='average', dy_met=0):
    """Depth from two normalized segment endpoints (shoulder & hip rays)."""
    assert mode in ('average', 'real')
    cc = -average_y if mode == 'average' else -dy_met
    return float(_solve_depths(float(xyz_norm_1[0]), float(xyz_norm_1[1]),
                               float(xyz_norm_2[0]), float(xyz_norm_2[1]), cc)[0])


def geometric_coordinates(keypoints, kk, average_y=AVERAGE_Y):
    """Geometric depths for all keypoints (batched least squares).

    Returns (zzs_geom list, xy_centers (m, 3) normalized rays).
    """
    kps = np.asarray(keypoints, np.float32)
    uv_shoulders = np_get_keypoints(kps, 'shoulder')
    uv_hips = np_get_keypoints(kps, 'hip')
    uv_centers = np_get_keypoints(kps, 'center')
    xy_shoulders = np_pixel_to_camera(uv_shoulders, kk, 1)
    xy_hips = np_pixel_to_camera(uv_hips, kk, 1)
    xy_centers = np_pixel_to_camera(uv_centers, kk, 1)

    depths = _solve_depths(xy_shoulders[:, 0], xy_shoulders[:, 1],
                           xy_hips[:, 0], xy_hips[:, 1], -average_y)
    return [float(z) for z in depths], xy_centers


def geometric_baseline(joints):
    """Statistics of segment heights and geometric-distance errors over a
    joints file (geom_baseline.py:32-72)."""
    cnt_tot = 0
    dic_dist = defaultdict(lambda: defaultdict(list))
    with open(joints, 'r') as ff:
        dic_joints = json.load(ff)

    for phase in ['train', 'val']:
        cnt_tot += _update_distances(dic_joints[phase], dic_dist, phase, AVERAGE_Y)

    dic_h_means = _calculate_heights(dic_dist['heights'], mode='mean')
    dic_h_stds = _calculate_heights(dic_dist['heights'], mode='std')
    errors = {clst: float(np.mean(v)) if v else float('nan')
              for clst, v in dic_dist['error'].items()}

    print(f"Computed distance of {cnt_tot} annotations")
    for key, h_mean in dic_h_means.items():
        print(f"Average height of segment {key} is {h_mean:.2f} "
              f"with a std of {dic_h_stds[key]:.2f}")
    for clst in CLUSTERS:
        if clst in errors:
            print(f"Average error over the val set for clst {clst}: {errors[clst]:.2f}")
    print(f"Joints used: {joints}")
    return errors


def _update_distances(dic_fin, dic_dist, phase, average_y):
    cnt = 0
    # The joints file stores gt labels in Y; reconstruct 3D box center from them.
    has_3d = 'boxes_3d' in dic_fin
    for idx, kps in enumerate(dic_fin['kps']):
        kps_arr = np.asarray(kps, np.float32)
        if kps_arr.ndim == 3:
            kps_arr = kps_arr[0]
        dic_uv = {mode: np_get_keypoints(kps_arr, mode)
                  for mode in ['head', 'shoulder', 'hip', 'ankle']}
        # K is stored per annotation by this repo's prep pipelines.
        ks = dic_fin.get('K', [])
        kk = ks[idx] if idx < len(ks) else (ks[0] if ks else None)
        if kk is None or (isinstance(kk, list) and not kk):
            continue
        if has_3d:
            box3d = dic_fin['boxes_3d'][idx]
            xyz_c = box3d[0:3]
        else:
            # Labels are spherical [theta, psi, z, r, ...]: recover xyz.
            lab = dic_fin['Y'][idx]
            z = lab[2]
            r = lab[3]
            theta, psi = lab[0], lab[1]
            x = r * math.sin(psi) * math.cos(theta)
            y = r * math.cos(psi)
            xyz_c = [x, y, z]
        z_met = xyz_c[2]

        dic_xyz = {key: np_pixel_to_camera(dic_uv[key], kk, z_met) for key in dic_uv}
        dic_xyz_norm = {key: np_pixel_to_camera(dic_uv[key], kk, 1) for key in dic_uv}
        dy_met = abs(float(dic_xyz['hip'][0][1] - dic_xyz['shoulder'][0][1]))
        z_real = compute_depth(dic_xyz_norm['shoulder'][0], dic_xyz_norm['hip'][0],
                               average_y, mode='real', dy_met=dy_met)
        z_approx = compute_depth(dic_xyz_norm['shoulder'][0], dic_xyz_norm['hip'][0],
                                 average_y, mode='average')
        d_real = math.sqrt(z_real ** 2 + xyz_c[0] ** 2 + xyz_c[1] ** 2)
        d_approx = math.sqrt(z_approx ** 2 + xyz_c[0] ** 2 + xyz_c[1] ** 2)

        if phase == 'train':
            for key in ('head', 'shoulder', 'hip', 'ankle'):
                dic_dist['heights'][key].append(float(dic_xyz[key][0][1]))
        if phase == 'val':
            error = abs(d_real - d_approx)
            if d_real <= 10:
                dic_dist['error']['10'].append(error)
            elif d_real <= 20:
                dic_dist['error']['20'].append(error)
            elif d_real <= 30:
                dic_dist['error']['30'].append(error)
            else:
                dic_dist['error']['>30'].append(error)
            dic_dist['error']['all'].append(error)
        cnt += 1
    return cnt


def _calculate_heights(heights, mode):
    assert mode in ('mean', 'std', 'max')
    fn = {'mean': np.mean, 'std': np.std, 'max': np.max}[mode]
    out = {}
    pairs = [('head_shoulder', 'shoulder', 'head'),
             ('shoulder_hip', 'hip', 'shoulder'),
             ('hip_ankle', 'ankle', 'hip')]
    for name, a, b in pairs:
        if heights[a] and heights[b]:
            out[name] = float(fn(np.array(heights[a]) - np.array(heights[b]))) * 100
        else:
            out[name] = float('nan')
    return out
