"""Stereo-aware data augmentation for prep: a host copy of
`monoloco_tpu/prep/transforms.py`.

- A horizontal flip of keypoints swaps left and right joints (one index
  permutation).
- `flip_labels` rebuilds the flipped ground truth with the stereo baseline's
  disparity shift, so right-camera poses become training data for a virtual
  left camera.
- `height_augmentation` resamples a person's height in [1.2, 2] m and
  shifts the right keypoints' disparity to match. It seeds `np.random` with
  the running pair counter, so prep outputs can be reproduced exactly.
"""

import math
from copy import deepcopy

import numpy as np

from ..geometry.host import correct_angle, to_cartesian, to_spherical

BASELINE = 0.54
BF = BASELINE * 721

COCO_KEYPOINTS = [
    'nose', 'left_eye', 'right_eye', 'left_ear', 'right_ear',
    'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
    'left_wrist', 'right_wrist', 'left_hip', 'right_hip',
    'left_knee', 'right_knee', 'left_ankle', 'right_ankle',
]

# Joint permutation for a horizontal flip: swap each left_* with right_*.
HFLIP_INDEX = np.array([0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15])


def transform_keypoints(keypoints, mode):
    """Egocentric horizontal flip: permute left/right joints."""
    assert mode == 'flip', "mode not recognized"
    kps = np.asarray(keypoints)
    return kps[:, :, HFLIP_INDEX].tolist()


def flip_inputs(keypoints, im_w, mode=None):
    """Horizontally flip keypoints (x -> im_w - x, joints permuted) or boxes."""
    if mode == 'box':
        boxes = deepcopy(keypoints)
        for box in boxes:
            x2 = box[2]
            box[2] = im_w - box[0]
            box[0] = im_w - x2
        return boxes
    kps = np.array(keypoints, dtype=np.float64)
    kps[:, 0, :] = im_w - kps[:, 0, :]
    return transform_keypoints(kps, mode='flip')


def flip_labels(boxes_gt, labels, im_w):
    """Flipped-gt boxes and labels for the virtual left camera.

    Labels are spherical [theta, psi, z, r, h, w, l, sin, cos, yaw]; the box is
    flipped and shifted by the stereo disparity BF/z, x becomes -x + baseline,
    and the yaw flips sign-symmetrically around pi.
    """
    boxes_flip = deepcopy(boxes_gt)
    labels_flip = deepcopy(labels)
    for idx, lab in enumerate(labels_flip):
        disp = BF / lab[2]
        x2 = boxes_flip[idx][2]
        boxes_flip[idx][2] = im_w - boxes_flip[idx][0] + disp
        boxes_flip[idx][0] = im_w - x2 + disp

        rtp = lab[3:4] + lab[0:2]              # [r, theta, psi]
        xyz = to_cartesian(rtp)
        xyz[0] = -xyz[0] + BASELINE
        rtp_r = to_spherical(xyz)
        lab[3], lab[0], lab[1] = rtp_r[0], rtp_r[1], rtp_r[2]

        yaw = lab[9]
        yaw_n = math.copysign(1, yaw) * (np.pi - abs(yaw))
        sin, cos, _ = correct_angle(yaw_n, xyz)
        lab[7], lab[8], lab[9] = sin, cos, yaw_n
    return boxes_flip, labels_flip


def height_augmentation(kps, kps_r, label_s, seed=0):
    """Resample person height in [1.2, 2] m; shift right-keypoint disparity and
    the z/r labels to the depth a person of that height would have.

    kps, kps_r: numpy arrays (1, 3, 17); label_s: list len 11 (stereo label).
    Returns (kps_aug [(kp, kp_r), ...], labels_aug). True pairs (s_match > 0.9)
    get 3 resamples + the original; negatives get 1 + original; a resample
    nearer than 2 m is skipped.
    """
    kps = np.asarray(kps)
    kps_r = np.asarray(kps_r)
    n_labels = 3 if label_s[-1] > 0.9 else 1
    height_min, height_max, av_height = 1.2, 2.0, 1.71
    kps_aug = [[kps.copy(), kps_r.copy()] for _ in range(n_labels + 1)]
    labels_aug = [list(label_s) for _ in range(n_labels + 1)]
    np.random.seed(seed)
    heights = np.random.uniform(height_min, height_max, n_labels)
    zzs = heights * label_s[2] / av_height
    disp = BF / label_s[2]

    rtp = label_s[3:4] + label_s[0:2]
    xyz = to_cartesian(rtp)
    for i in range(n_labels):
        if zzs[i] < 2:
            continue
        disp_new = BF / zzs[i]
        kps_aug[i][1][0, 0, :] = kps_aug[i][1][0, 0, :] + (disp - disp_new)
        labels_aug[i][2] = zzs[i]
        xyz[2] = zzs[i]
        labels_aug[i][3] = float(np.linalg.norm(xyz))
    return [tuple(pair) for pair in kps_aug], labels_aug
