"""Activity recognition on top of 3D localization outputs: social
distancing (F-formation detection) and raised-hand detection.

A host copy of `monoloco_tpu/activity.py`, so the port never imports the JAX
package. These run on the host per image on a handful of people; the
probabilistic branch tests all n_samples Laplace-resampled scenes of a
candidate pair in one stack of array ops (the JAX package's copy loops over
the samples in Python, 100 calls of `check_f_formations` a pair).
matplotlib is imported inside `show_activities` only.
"""

import math

import numpy as np

from .geometry.host import np_laplace_sampling


def social_interactions(idx, centers, angles, dds, stds=None, social_distance=False,
                        n_samples=100, threshold_prob=0.25, threshold_dist=2,
                        radii=(0.3, 0.5)):
    """Return True if person `idx` violates social distancing / joins an
    F-formation with someone within `threshold_dist`."""
    xx, zz = centers[idx][0], centers[idx][1]
    distances = [math.sqrt((xx - c[0]) ** 2 + (zz - c[1]) ** 2) for c in centers]
    sorted_idxs = np.argsort(distances)
    indices = [int(i) for i in sorted_idxs[1:] if distances[int(i)] <= threshold_dist]

    if n_samples < 2:  # deterministic
        return any(
            check_f_formations(idx, idx_t, centers, angles, radii=radii,
                               social_distance=social_distance)
            for idx_t in indices
        )

    # Probabilistic: resample each person's distance from Laplace(d, b) and
    # shift their position along the camera ray accordingly.
    dds_arr = np.asarray(dds, dtype=np.float32).reshape(-1, 1)
    stds_arr = np.asarray(stds, dtype=np.float32).reshape(-1, 1)
    laplace_d = np.concatenate([dds_arr, stds_arr], axis=1)
    samples_d = np_laplace_sampling(laplace_d, n_samples=n_samples)  # (S, m)

    centers_np = np.asarray([[c[0], c[1]] for c in centers], dtype=np.float64)
    thetas = np.arctan2(centers_np[:, 1], centers_np[:, 0])  # (m,)
    # delta position per sample s and person e: (d_e - sample[s,e]) * (cos, sin)(theta_e)
    delta_d = dds_arr[:, 0][None, :] - samples_d  # (S, m)
    delta_xz = np.stack([delta_d * np.cos(thetas)[None, :],
                         delta_d * np.sin(thetas)[None, :]], axis=-1)  # (S, m, 2)

    for idx_t in indices:
        # every sample's scene at once: (S, m, 2), the pair moved along its rays
        new_centers = np.repeat(centers_np[None], n_samples, axis=0)
        for el in (idx, idx_t):
            new_centers[:, el] += delta_xz[:, el]
        hits = int(np.count_nonzero(_f_formations(idx, idx_t, new_centers, angles, radii,
                                                  social_distance)))
        if hits / n_samples >= threshold_prob:
            return True
    return False


def check_f_formations(idx, idx_t, centers, angles, radii, social_distance=False):
    """F-formation test for a candidate pair: the o-space center (average of
    the two orientation-projected points) must be closer to both projected
    points than to the originals (looking inward), and no third person may
    intrude within `radius` of it."""
    centers_np = np.asarray([[c[0], c[1]] for c in centers], dtype=np.float64)
    return bool(_f_formations(idx, idx_t, centers_np[None], angles, radii, social_distance)[0])


def _norms(v):
    """Euclidean norms over the last axis, each summed as a dot product, as
    `np.linalg.norm` sums a single vector."""
    return np.sqrt((v[..., None, :] @ v[..., :, None])[..., 0, 0])


def _f_formations(idx, idx_t, centers, angles, radii, social_distance):
    """`check_f_formations` over a stack of scenes: centers (S, m, 2)
    float64 -> (S,) bool."""
    other = np.delete(centers, [idx, idx_t], axis=1)
    theta0, theta1 = angles[idx], angles[idx_t]
    x_0, x_1 = centers[:, idx], centers[:, idx_t]
    found = np.zeros(centers.shape[0], bool)

    for radius in radii:
        mu_0 = np.stack([x_0[:, 0] + radius * math.cos(theta0),
                         x_0[:, 1] - radius * math.sin(theta0)], axis=-1)
        mu_1 = np.stack([x_1[:, 0] + radius * math.cos(theta1),
                         x_1[:, 1] - radius * math.sin(theta1)], axis=-1)
        o_c = (mu_0 + mu_1) / 2

        d_new = _norms(mu_0 - mu_1) / 2 if social_distance else _norms(mu_0 - mu_1)
        d_0 = _norms(x_0 - o_c)
        d_1 = _norms(x_1 - o_c)

        if other.shape[1]:
            min_other = np.min(np.linalg.norm(other - o_c[:, None, :], axis=-1), axis=1)
        else:
            min_other = 100.0

        found |= (d_new <= np.minimum(d_0, d_1)) & (min_other > radius)
    return found


# COCO-17 joint indices
_NOSE, _L_EAR, _R_EAR = 0, 3, 4
_L_SHOULDER, _R_SHOULDER = 5, 6
_L_ELBOW, _R_ELBOW = 7, 8
_L_HAND, _R_HAND = 9, 10


def is_raising_hand(kp):
    """Geometric raised-hand rule.

    kp: [xs(17), ys(17), (confs)] in pixel coordinates (y grows downward).
    Returns 'left' | 'right' | 'both' | None.
    """
    x, y = 0, 1
    head_width = kp[x][_L_EAR] - kp[x][_R_EAR]
    head_top = kp[y][_NOSE] - head_width

    def arm_angle(hand, elbow, shoulder):
        forearm = np.array([kp[x][hand] - kp[x][elbow], kp[y][hand] - kp[y][elbow]])
        arm = np.array([kp[x][shoulder] - kp[x][elbow], kp[y][shoulder] - kp[y][elbow]])
        norms = np.linalg.norm(forearm) * np.linalg.norm(arm)
        if norms == 0.0:
            # Collapsed forearm/arm (hand == elbow or elbow == shoulder): the
            # angle is taken as 0, so the arm is never "risen".
            return 0.0
        cosang = np.clip(np.dot(forearm, arm) / norms, -1.0, 1.0)
        return (90 / np.pi) * np.arccos(cosang)

    l_angle = arm_angle(_L_HAND, _L_ELBOW, _L_SHOULDER)
    r_angle = arm_angle(_R_HAND, _R_ELBOW, _R_SHOULDER)

    is_l_up = kp[y][_L_HAND] < kp[y][_L_SHOULDER]
    is_r_up = kp[y][_R_HAND] < kp[y][_R_SHOULDER]
    l_too_close = kp[x][_L_HAND] <= kp[x][_L_SHOULDER] and kp[y][_L_HAND] >= head_top
    r_too_close = kp[x][_R_HAND] >= kp[x][_R_SHOULDER] and kp[y][_R_HAND] >= head_top

    is_left_risen = is_l_up and l_angle >= 30 and not l_too_close
    is_right_risen = is_r_up and r_angle >= 30 and not r_too_close

    if is_left_risen and is_right_risen:
        return 'both'
    if is_left_risen:
        return 'left'
    if is_right_risen:
        return 'right'
    return None


def show_activities(args, image, output_path, annotations, dic_out):
    """Render front and/or bird views highlighting detected activities."""
    from contextlib import contextmanager
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from .visuals.pifpaf_show import KeypointPainter, image_canvas, get_pifpaf_outputs
    from .visuals.printer import draw_orientation, draw_uncertainty, social_distance_colors

    assert 'front' in args.output_types or 'bird' in args.output_types, \
        "outputs allowed: front and/or bird"

    colors = ['deepskyblue' for _ in dic_out['uv_heads']]
    if 'social_distance' in args.activities:
        colors = social_distance_colors(colors, dic_out)

    angles = dic_out['angles']
    stds = dic_out['stds_ale']
    xz_centers = [[xx[0], xx[2]] for xx in dic_out['xyz_pred']]

    if 'front' in args.output_types:
        keypoint_sets, _ = get_pifpaf_outputs(annotations)
        idxs = dic_out.get('indices')
        if idxs:
            # post_process filters and reorders detections (gt matching,
            # left-right); paint skeletons in output order so each one gets
            # its own color and activity flag.
            keypoint_sets = [keypoint_sets[j] for j in idxs]
        uv_centers = dic_out['uv_heads']
        sizes = [abs(dic_out['uv_heads'][idx][1] - uv_s[1]) / 1.5
                 for idx, uv_s in enumerate(dic_out['uv_shoulders'])]
        painter = KeypointPainter(show_box=False)
        with image_canvas(image, output_path + '.front.png',
                          show=getattr(args, 'show', False), fig_width=10) as ax:
            painter.keypoints(ax, keypoint_sets, activities=args.activities,
                              dic_out=dic_out, size=image.size, colors=colors)
            draw_orientation(ax, uv_centers, sizes, angles, colors, mode='front')

    if 'bird' in args.output_types:
        z_max = min(args.z_max, 4 + max([el[1] for el in xz_centers], default=0))

        @contextmanager
        def bird_canvas():
            fig, ax = plt.subplots(1, 1)
            fig.set_tight_layout(True)
            x_max = z_max / 1.5
            ax.plot([0, x_max], [0, z_max], 'k--')
            ax.plot([0, -x_max], [0, z_max], 'k--')
            ax.set_ylim(0, z_max + 1)
            yield ax
            fig.savefig(output_path + '.bird.png')
            plt.close(fig)
            print('Bird-eye-view image saved')

        with bird_canvas() as ax1:
            draw_orientation(ax1, xz_centers, [], angles, colors, mode='bird')
            draw_uncertainty(ax1, xz_centers, stds)
