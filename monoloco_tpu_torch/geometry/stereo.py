"""Stereo disparity utilities (host numpy).

A copy of `monoloco_tpu/geometry/stereo.py`, which the port cannot import
(`monoloco_tpu.geometry` imports jax). The per-joint masking and medians are
vectorized over the full (m_left, m_right, 17) tensor; the training match
selection (`extract_stereo_matches`) keeps the seeded np.random calls of the
reference, so that prep outputs can be reproduced bit for bit.
"""

import warnings

import numpy as np

BF = 0.54 * 721  # baseline * focal length of the KITTI stereo rig
Z_MIN = 4
Z_MAX = 60
D_MIN = BF / Z_MAX
D_MAX = BF / Z_MIN


def depth_to_pixel_error(zz, depth_error=1):
    """Pixel disparity error corresponding to a depth error: e_d = B*f*e_z/z^2."""
    return BF * depth_error / (zz ** 2)


def disparity_to_depth(avg_disparity):
    """z = B*f/disparity. Returns (z, ok_flag); flag False on nan/zero disparity."""
    try:
        zz = BF / float(avg_disparity)
        if np.isnan(zz):
            return np.nan, False
        return zz, True
    except (ZeroDivisionError, ValueError):
        return np.nan, False


def interquartile_mask(distribution):
    """Tukey-fence inlier mask over the last axis of a (m, k) array."""
    q1, q3 = np.nanpercentile(distribution, [25, 75], axis=-1)
    iqr = q3 - q1
    lower = (q1 - 1.5 * iqr)[..., None]
    upper = (q3 + 1.5 * iqr)[..., None]
    return (distribution < upper) & (distribution > lower)


def mask_joint_disparity(keypoints, keypoints_r, conf_min=0.3):
    """Per-joint disparities masked by confidence and IQR outliers, with the
    median x-disparity per (left, right) pair.

    keypoints (m, 3, 17), keypoints_r (r, 3, 17) ->
      avg_disparity (m, r), disparity_x_mask (m, r, 17), disparity_y_mask (m, r, 17)
    """
    kl = np.asarray(keypoints, dtype=np.float64)
    kr = np.asarray(keypoints_r, dtype=np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        disp_x = kl[:, None, 0, :] - kr[None, :, 0, :]  # (m, r, 17)
        disp_y = kl[:, None, 1, :] - kr[None, :, 1, :]
        conf = (kl[:, None, 2, :] > conf_min) & (kr[None, :, 2, :] > conf_min)
        disp_x_conf = np.where(conf, disp_x, np.nan)
        disp_y_conf = np.where(conf, disp_y, np.nan)
        inlier = interquartile_mask(disp_x_conf)
        x_mask = np.where(inlier, disp_x_conf, np.nan)
        y_mask = np.where(inlier, disp_y_conf, np.nan)
        avg = np.nanmedian(x_mask, axis=-1)
    return avg, x_mask, y_mask


def average_locations(keypoint, keypoints_r, conf_min=0.2):
    """Median absolute x-locations of one left pose against all right poses.

    keypoint (1, 3, 17), keypoints_r (r, 3, 17) ->
      avgs_x_l (r,), avgs_x_r (r,), x_disp (r, 17), y_disp (r, 17)

    The joint inlier mask is shared between left and right.
    """
    kl = np.asarray(keypoint, dtype=np.float64)
    kr = np.asarray(keypoints_r, dtype=np.float64)
    assert kr.shape[0] > 0, "No right keypoints"
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        mask_l = kl[0, 2, :] > conf_min
        mask_r = kr[:, 2, :] > conf_min
        abs_x_l = np.where(mask_l, kl[0, 0:1, :], np.nan)   # (1, 17)
        abs_x_r = np.where(mask_r, kr[:, 0, :], np.nan)      # (r, 17)
        mask = interquartile_mask(abs_x_l) & interquartile_mask(abs_x_r)
        x_l = np.where(mask, abs_x_l, np.nan)
        x_r = np.where(mask, abs_x_r, np.nan)
        x_disp = x_l - x_r
        y_disp = np.where(mask, kl[0, 1, :] - kr[:, 1, :], np.nan)
        avgs_x_l = np.nanmedian(x_l, axis=-1)
        avgs_x_r = np.nanmedian(x_r, axis=-1)
    return avgs_x_l, avgs_x_r, x_disp, y_disp


def verify_stereo(zz_stereo, zz_mono, disparity_x, disparity_y):
    """Sanity gates on a stereo depth estimate."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        y_max_difference = 80 / zz_mono
        z_max_difference = 1.0 * zz_mono
        avg_disparity_y = np.nanmedian(disparity_y)
    return (
        abs(zz_stereo - zz_mono) < z_max_difference
        and avg_disparity_y < y_max_difference
        and 1 < zz_stereo < 80
    )


def extract_stereo_matches(keypoint, keypoints_r, zz, phase='train', seed=0, method=None):
    """Select the stereo match (and training negatives) for one left pose.

    Returns ([(right_idx, is_match)], n_ambiguous). The decision cascade of
    the reference, including its seeded easy-negative sampling
    (np.random.seed(seed + rank)), so that prep outputs are bit-identical.
    """
    conf_min = 0.1 if method == 'mask' else 0.2
    avgs_x_l, avgs_x_r, disp_x, disp_y = average_locations(keypoint, keypoints_r, conf_min=conf_min)
    avg_disparities = [abs(float(l) - BF / zz - float(r)) for l, r in zip(avgs_x_l, avgs_x_r)]
    idx_matches = np.argsort(avg_disparities)

    error_max_stereo = 0.2 * zz + 0.2
    error_min_mono = 0.25 * zz + 0.2
    error_max_mono = 1.0 * zz + 0.5

    stereo_matches = []
    cnt_ambiguous = 0
    used = []
    for rank, idx_match in enumerate(idx_matches):
        match = avg_disparities[idx_match]
        zz_stereo, ok = disparity_to_depth(match + BF / zz)

        accept = (
            rank == 0
            and match < depth_to_pixel_error(zz, depth_error=error_max_stereo)
            and ok
            and verify_stereo(zz_stereo, zz, disp_x[idx_match], disp_y[idx_match])
        )
        if accept:
            stereo_matches.append((idx_match, 1))
        elif match < depth_to_pixel_error(zz, depth_error=error_min_mono):
            cnt_ambiguous += 1
        elif (
            phase == 'val'
            and match < depth_to_pixel_error(zz, depth_error=error_max_mono)
            and not stereo_matches
            and zz < 40
        ):
            stereo_matches.append((idx_match, 0))
        elif (
            phase == 'train'
            and match < depth_to_pixel_error(zz, depth_error=error_max_mono)
            and len(stereo_matches) < 3
        ):
            stereo_matches.append((idx_match, 0))
        elif phase == 'train' and len(stereo_matches) < 3:
            np.random.seed(seed + rank)
            num = np.random.randint(rank, len(idx_matches))
            if idx_matches[num] not in used:
                stereo_matches.append((idx_matches[num], 0))
        else:
            break
        used.append(idx_match)

    return stereo_matches, cnt_ambiguous
