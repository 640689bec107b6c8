"""KITTI ground truth and pifpaf annotation loading: a host copy of
`parse_ground_truth` and `factory_file` of `monoloco_tpu/prep/preprocess_kitti.py`,
which EvalKitti and GenerateKitti read through.

Unlike the JAX module, this one imports no Pillow: the card's machine has
none. `PreprocessKitti` (joints and names JSON for training) is not ported
yet (ROADMAP Queue 1 item 5).
"""

import math
import os

from ..geometry import correct_angle, open_annotations, to_spherical
from ..utils import check_conditions, get_calibration


def parse_ground_truth(path_gt, category, spherical=False):
    """Parse a KITTI gt txt file into boxes + labels.

    spherical=True: label = [theta, psi, z, r, h, w, l, sin_a, cos_a, yaw, cat]
    spherical=False: label = [x, y, z, d, h, w, l, sin_a, cos_a, yaw, cat]
    Validates alpha ~= yaw - atan2(x, z) within 0.15 rad.
    """
    boxes, labels, truncs, occs, raw_lines = [], [], [], [], []
    with open(path_gt, 'r') as f:
        for raw in f:
            if not check_conditions(raw, category, method='gt'):
                continue
            fields = raw.split()
            xyz = [float(v) for v in fields[11:14]]
            yaw = float(fields[14])
            assert -math.pi <= yaw <= math.pi
            sin_a, cos_a, yaw_ego = correct_angle(yaw, xyz)
            alpha = float(fields[3])
            assert min(abs(-yaw_ego - alpha), abs(yaw_ego - alpha)) < 0.15, \
                "more than 10 degrees of error"
            if spherical:
                r_t_p = to_spherical(xyz)
                loc = r_t_p[1:3] + xyz[2:3] + r_t_p[0:1]   # [theta, psi, z, r]
            else:
                # The reference's exact formula: a nested hypot differs in the
                # last ulp on ~19% of inputs, which moves distance-cluster
                # binning.
                loc = xyz + [math.sqrt(xyz[0] ** 2 + xyz[1] ** 2 + xyz[2] ** 2)]
            truncs.append(float(fields[1]))
            occs.append(int(fields[2]))
            boxes.append([float(v) for v in fields[4:8]])
            hwl = [float(v) for v in fields[8:11]]
            labels.append(loc + hwl + [sin_a, cos_a, yaw, fields[0]])
            raw_lines.append(raw)
    return boxes, labels, truncs, occs, raw_lines


def factory_file(path_calib, dir_ann, basename, ann_type='left'):
    """Load the pifpaf annotation json + calibration for one image."""
    assert ann_type in ('left', 'right')
    calib_left, calib_right = get_calibration(path_calib)
    kk, tt = calib_left if ann_type == 'left' else calib_right
    ann_dir = dir_ann if ann_type == 'left' else dir_ann + '_right'
    annotations = open_annotations(
        os.path.join(ann_dir, basename + '.png.predictions.json'))
    return annotations, kk, tt
