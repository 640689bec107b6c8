"""Stereo association baselines for the KITTI evaluation: a host copy of
`monoloco_tpu/eval/stereo_baselines.py`.

A greedy min-cost association of left and right poses under one of three
costs: 'pose' (zero-centred keypoint distance), 'reid' (the distance of
appearance features, whatever produced them) and 'ml_stereo' (the gap
between the disparity the mono depth implies and the pair's). Depth comes
from the pair's median masked joint disparity; unmatched or rejected poses
keep the monocular depth.
"""

from collections import defaultdict

import numpy as np

from ..geometry import mask_joint_disparity, disparity_to_depth
from ..geometry.host import np_get_keypoints


def baselines_association(baselines, zzs, keypoints, keypoints_right, reid_features):
    """Compute stereo depth for each baseline. Returns (dict of z lists, counts)."""
    zzs_stereo = defaultdict(list)
    cnt_stereo = defaultdict(int)

    features, features_r, kps, kps_r = _factory_features(
        keypoints, keypoints_right, baselines, reid_features)
    cnt_stereo['max'] = min(kps.shape[0], kps_r.shape[0])

    avg_disparities, _, _ = mask_joint_disparity(kps, kps_r)

    for key in baselines:
        similarity = _features_similarity(features[key], features_r[key], key,
                                          avg_disparities, zzs)
        zz_out = np.empty((kps.shape[0],))
        indices_stereo = []
        sim = similarity.astype(np.float64).copy()
        while not np.all(np.isnan(sim)):
            idx, arg_best = np.unravel_index(np.nanargmin(sim), sim.shape)
            zz_stereo, flag = disparity_to_depth(avg_disparities[idx, arg_best])
            zz_mono = zzs[idx]
            sim[idx, :] = np.nan
            indices_stereo.append(idx)
            if flag and 1 < zz_stereo < 80:
                zz_out[idx] = zz_stereo
                cnt_stereo[key] += 1
                sim[:, arg_best] = np.nan
            else:
                zz_out[idx] = zz_mono
        for idx in range(len(zzs)):
            if idx not in indices_stereo:
                zz_out[idx] = zzs[idx]
        zzs_stereo[key] = zz_out.tolist()

    return zzs_stereo, cnt_stereo


def _factory_features(keypoints, keypoints_right, baselines, reid_features):
    features, features_r = {}, {}
    for key in baselines:
        if key == 'reid':
            features[key] = np.asarray(reid_features[0])
            features_r[key] = np.asarray(reid_features[1])
        else:
            features[key] = np.asarray(keypoints)
            features_r[key] = np.asarray(keypoints_right)
    return features, features_r, np.asarray(keypoints), np.asarray(keypoints_right)


def _features_similarity(features, features_r, key, avg_disparities, zzs):
    """Pairwise association cost (m_left, m_right), fully vectorized."""
    if key == 'ml_stereo':
        expected = 0.54 * 721.0 / np.asarray(zzs)[:, None]
        return np.abs(expected - avg_disparities)

    if key == 'pose':
        # Zero-centered keypoint L2 distance.
        centers_l = np_get_keypoints(features, 'center')[:, :, None]     # (m, 2, 1)
        centers_r = np_get_keypoints(features_r, 'center')[:, :, None]
        f_l = (features[:, :2, :] - centers_l).reshape(features.shape[0], -1)
        f_r = (features_r[:, :2, :] - centers_r).reshape(features_r.shape[0], -1)
        return np.linalg.norm(f_l[:, None, :] - f_r[None, :, :], axis=2)

    # ReID feature distance.
    return np.linalg.norm(features[:, None, :] - features_r[None, :, :], axis=2)
