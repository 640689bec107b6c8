"""KITTI preprocessing: ground-truth txt + pifpaf predictions -> the joints
and names JSON files that training and evaluation read. A host copy of
`monoloco_tpu/prep/preprocess_kitti.py`.

`PreprocessKitti` streams each scene through `_ingest_scene` as a list of
`_View` records (the original and, for training scenes with right-camera
poses, a stereo-flipped one). The stereo cascade is seeded by explicit pair
counters, and scenes are taken in sorted order, so prep output can be
reproduced annotation for annotation and equals the JAX package's.

Output schema: {train|val|test: {X, Y, names, kps, K, clst}, version} for
the joints file and {<image>: {boxes, ys, K}} for the names file.
`parse_ground_truth` and `factory_file` are also what EvalKitti and
GenerateKitti read through.

Unlike the JAX module, this one imports no Pillow (the card's machine has
none): image sizes come from the PNG header (`predict.image_size`).
Everything here is host numpy; prep runs on no device.
"""

import copy
import datetime
import json
import logging
import math
import os
import warnings
from collections import defaultdict, namedtuple

import numpy as np

from .. import __version__
from ..geometry import correct_angle, extract_stereo_matches, get_iou_matches, \
    open_annotations, to_spherical
from ..geometry.host import np_preprocess_monoloco
from ..network.preprocess import preprocess_pifpaf
from ..predict import image_size
from ..utils import append_cluster, check_conditions, get_calibration, \
    make_new_directory, split_training
from .transforms import flip_inputs, flip_labels, height_augmentation

# One padded view of a scene: detections on the "left" camera paired with the
# ground truth they can match against, plus the right-camera poses for stereo.
_View = namedtuple('_View', 'det_boxes kps_left kps_right gt_boxes gt_labels is_flip')

_PHASES = ('train', 'val', 'test')


def _fresh_split():
    return dict(X=[], Y=[], names=[], kps=[], K=[],
                clst=defaultdict(lambda: defaultdict(list)))


class PreprocessKitti:
    """Build training arrays from KITTI ground truth + pifpaf annotations."""

    dir_gt = os.path.join('data', 'kitti', 'gt')
    dir_images = os.path.join('data', 'kitti', 'images')
    dir_kk = os.path.join('data', 'kitti', 'calib')

    # Social-distancing ground-truth augmentation parameters
    THRESHOLD_DIST = 2
    RADII = (0.3, 0.5, 1)
    SOCIAL_DISTANCE = True

    logger = logging.getLogger(__name__)
    # gt categories admitted per phase (sitting people for training only).
    KEEP_CATEGORIES = dict(train=('Pedestrian', 'Person_sitting'),
                           val=('Pedestrian',))

    def __init__(self, dir_ann, mode='mono', iou_min=0.3, sample=False,
                 dir_splits='splits'):
        assert mode in ('mono', 'stereo'), "modality not recognized"
        self.dir_ann = dir_ann
        self.mode = mode
        self.iou_min = iou_min
        self.sample = sample

        self._require_dir(self.dir_ann, 'Annotation')
        self._require_dir(self.dir_gt, 'Ground-truth')
        right_ok = (os.path.isdir(dir_ann + '_right')
                    and any(os.scandir(dir_ann + '_right')))
        if self.mode == 'stereo':
            assert right_ok, "Annotation directory for right images not found/empty"
        elif not right_ok:
            warnings.warn('Horizontal flipping not applied as annotation directory '
                          'for right images not found/empty')

        self.dic_jo = {ph: _fresh_split() for ph in _PHASES}
        self.dic_jo['version'] = __version__
        self.dic_names = defaultdict(lambda: defaultdict(list))

        # sorted: the stereo cascade's np.random seeds advance with global
        # iteration order, so scene order must not depend on the filesystem
        self.names_gt = tuple(sorted(os.listdir(self.dir_gt)))
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M")[2:]
        arrays = os.path.join('data', 'arrays')
        self.path_joints = os.path.join(arrays, f'joints-kitti-{mode}-{stamp}.json')
        self.path_names = os.path.join(arrays, f'names-kitti-{mode}-{stamp}.json')
        self.set_train, self.set_val = split_training(
            self.names_gt,
            os.path.join(dir_splits, 'kitti_train.txt'),
            os.path.join(dir_splits, 'kitti_val.txt'))

        # Scene/match counters (mono) and the stereo pair counters that seed
        # the reproducible np.random draws of the stereo cascade.
        self.stats = defaultdict(int)
        self.stats_stereo = defaultdict(int)

    @staticmethod
    def _require_dir(path, what):
        assert os.path.isdir(path), f"{what} directory not found"
        assert any(os.scandir(path)), f"{what} directory empty"

    # ------------------------------------------------------------------

    def run(self):
        for gt_name in self.names_gt:
            phase = self._phase_of(gt_name)
            if phase is None:
                self.stats['fnf'] += 1
                continue
            self._ingest_scene(gt_name, phase)

        os.makedirs(os.path.dirname(self.path_joints), exist_ok=True)
        with open(self.path_joints, 'w') as f:
            json.dump(self.dic_jo, f)
        with open(self.path_names, 'w') as f:
            json.dump(self.dic_names, f)
        self._report()
        return self.path_joints, self.path_names

    def _ingest_scene(self, gt_name, phase):
        """One gt file: parse labels, match detections, store annotations."""
        basename, _ = os.path.splitext(gt_name)
        # Training keeps every class for matching ('all'); val is
        # pedestrian-only like the evaluation.
        gt_boxes, gt_labels, _, _, _ = parse_ground_truth(
            os.path.join(self.dir_gt, gt_name),
            category='all' if phase == 'train' else 'pedestrian',
            spherical=True)

        self.stats['gt_' + phase] += len(gt_boxes)
        self.stats['gt_files'] += 1
        self.stats['gt_files_ped'] += min(len(gt_boxes), 1)
        image_key = basename + '.png'
        self.dic_names[image_key]['boxes'] = copy.deepcopy(gt_boxes)
        self.dic_names[image_key]['ys'] = copy.deepcopy(gt_labels)

        loaded = self._scene_views(basename, phase, gt_boxes, gt_labels)
        if loaded is None:
            return
        kk, views = loaded
        self.dic_names[image_key]['K'] = copy.deepcopy(kk)

        keep = self.KEEP_CATEGORIES[phase]
        for view in views:
            kps_l = np.asarray(view.kps_left, dtype=np.float64)
            kps_r = np.asarray(view.kps_right, dtype=np.float64)
            matches = get_iou_matches(view.det_boxes, view.gt_boxes, self.iou_min)
            if view.is_flip:
                self.stats['flipping_match'] += len(matches)
            for det_idx, gt_idx in matches:
                labeled = view.gt_labels[gt_idx]
                if labeled[-1] not in keep:   # trailing element is the category
                    continue
                self.stats['match'] += 1
                label = labeled[:-1]
                assert len(label) == 10, 'dimensions of monocular label is wrong'
                one_kp = kps_l[det_idx:det_idx + 1]
                if self.mode == 'mono':
                    self._store_mono(phase, gt_name, one_kp, kk, label)
                else:
                    self._store_stereo(phase, gt_name, one_kp, kk, label, kps_r)

    def _scene_views(self, basename, phase, gt_boxes, gt_labels):
        """Load detections; return (K, [views]) or None when nothing detected.

        Training scenes with right-camera poses yield a second, horizontally
        flipped view whose gt is disparity-corrected (stereo-flip
        augmentation); without right poses the first left pose stands in so
        the stereo pairing code keeps a static shape.
        """
        im_w, im_h = image_size(os.path.join(self.dir_images, basename + '.png'))
        path_calib = os.path.join(self.dir_kk, basename + '.txt')
        conf_floor = 0 if phase == 'train' else 0.1

        annotations, kk, _ = factory_file(path_calib, self.dir_ann, basename)
        det_boxes, kps = preprocess_pifpaf(annotations, im_size=(im_w, im_h),
                                           min_conf=conf_floor)
        if not kps:
            return None
        self.stats['instances'] += len(kps)

        # Right-camera poses feed only the stereo pairing and the train-phase
        # flip augmentation; mono val/test scenes never consume them.
        if self.mode == 'mono' and phase != 'train':
            det_boxes_r, kps_r = [], []
        else:
            annotations_r, _, _ = factory_file(path_calib, self.dir_ann, basename,
                                               ann_type='right')
            det_boxes_r, kps_r = preprocess_pifpaf(annotations_r,
                                                   im_size=(im_w, im_h),
                                                   min_conf=conf_floor)

        if not kps_r:
            views = [_View(det_boxes, kps, kps[0:1].copy(), gt_boxes, gt_labels,
                           is_flip=False)]
        else:
            views = [_View(det_boxes, kps, kps_r, gt_boxes, gt_labels,
                           is_flip=False)]
            if phase == 'train':
                gt_boxes_f, gt_labels_f = flip_labels(gt_boxes, gt_labels, im_w=im_w)
                views.append(_View(
                    flip_inputs(det_boxes_r, im_w=im_w, mode='box'),
                    flip_inputs(kps_r, im_w=im_w),
                    flip_inputs(kps, im_w=im_w),
                    gt_boxes_f, gt_labels_f, is_flip=True))
        return kk, views

    # ------------------------------------------------------------------

    def _append(self, phase, gt_name, inp, label, keypoint, kk):
        split = self.dic_jo[phase]
        split['kps'].append(keypoint)
        split['X'].append(inp)
        split['Y'].append(label)
        split['names'].append(gt_name)
        # One K per annotation (not per image): the geometric baseline
        # back-projects each annotation with its own calibration.
        split['K'].append(kk)
        append_cluster(self.dic_jo, phase, inp, label, keypoint)

    def _store_mono(self, phase, gt_name, kp, kk, label):
        inp = np_preprocess_monoloco(kp, kk).reshape(-1).tolist()
        self._append(phase, gt_name, inp, label, kp.tolist(), kk)
        self.stats['total_' + phase] += 1

    def _store_stereo(self, phase, gt_name, kp, kk, label, kps_r):
        st = self.stats_stereo
        # The running pair count seeds the cascade's np.random draws — it must
        # advance in exactly this order for reproducible prep output.
        stereo_matches, n_ambiguous = extract_stereo_matches(
            kp, kps_r, label[2], phase=phase, seed=st['pair'])
        st['ambiguous'] += n_ambiguous

        for right_idx, s_match in stereo_matches:
            if s_match > 0.9:
                st['true_pair'] += 1
            st['pair'] += 1
            label_s = label + [s_match]

            resample = (phase == 'train' and 3 < label[2] < 30
                        and (s_match > 0.9 or st['pair'] % 2 == 0))
            if resample:
                kps_aug, labels_aug = height_augmentation(
                    kp, kps_r[right_idx:right_idx + 1], label_s, seed=st['pair'])
            else:
                kps_aug = [(kp, kps_r[right_idx:right_idx + 1])]
                labels_aug = [label_s]

            for (kp_l, kp_r), lab in zip(kps_aug, labels_aug):
                assert len(lab) == 11, 'dimensions of stereo label is wrong'
                st['pair_aug'] += 1
                x_l = np_preprocess_monoloco(kp_l, kk).reshape(-1)
                x_r = np_preprocess_monoloco(kp_r, kk).reshape(-1)
                stacked_kp = np.concatenate(
                    [np.asarray(kp_l), np.asarray(kp_r)], axis=2).tolist()
                inp = np.concatenate([x_l, x_l - x_r]).tolist()
                self._append(phase, gt_name, inp, lab, stacked_kp, kk)
                st['total_' + phase] += 1

    # ------------------------------------------------------------------

    def _report(self):
        s, st = self.stats, self.stats_stereo
        gt_total = s['gt_train'] + s['gt_val']
        direct = s['match'] - s['flipping_match']
        sep = '-' * 100
        print(sep)
        print(f"gt files parsed: {s['gt_files']} "
              f"(with people: {s['gt_files_ped']}, unmatched to a split: {s['fnf']})")
        print(sep)
        if gt_total:
            print(f"left-image gt recall: {100 * direct / gt_total:.1f}%")
        print(f"pifpaf instances seen: {s['instances']}; gt instances: {gt_total}")
        print(f"matched: {direct} directly, {s['match']} counting the stereo-flip views")
        if self.mode == 'stereo':
            print(sep)
            print(f"ambiguous candidates dropped: {st['ambiguous']}")
            if st['pair']:
                print(f"true stereo pairs: {100 * st['true_pair'] / st['pair']:.1f}%")
            print(f"height-resampled extras: {st['pair_aug'] - st['pair']}")
        totals = st if self.mode == 'stereo' else s
        print(sep)
        print(f"annotations written — train: {totals['total_train']}, "
              f"val: {totals['total_val']}")
        print(f"\nOutput files:\n{self.path_names}\n{self.path_joints}")
        print(sep)

    # ------------------------------------------------------------------

    def process_activity(self):
        """Augment the val split's KITTI gt files with a social-distance
        activity flag (a trailing 0 or 1 on each row), into
        data/kitti/gt_activity."""
        from ..activity import social_interactions
        dir_gt = os.path.join('data', 'kitti', 'gt')
        dir_out = os.path.join('data', 'kitti', 'gt_activity')
        make_new_directory(dir_out)
        n_pos = n_neg = 0

        for name in self.set_val:
            _, ys, _, _, lines = parse_ground_truth(
                os.path.join(dir_gt, name), 'pedestrian', spherical=False)
            # Cartesian labels: [x, y, z, dd, h, w, l, sin, cos, yaw, cat]
            angles = [y[9] for y in ys]
            dds = [y[3] for y in ys]
            xz_centers = [[y[0], y[2]] for y in ys]

            with open(os.path.join(dir_out, name), 'w+') as ff:
                for idx, line in enumerate(lines):
                    flag = social_interactions(
                        idx, xz_centers, angles, dds, n_samples=1,
                        threshold_dist=self.THRESHOLD_DIST, radii=self.RADII,
                        social_distance=self.SOCIAL_DISTANCE)
                    n_pos += flag
                    n_neg += not flag
                    # rstrip, then the flag: splicing it in before the last
                    # character corrupts a last line without a newline
                    ff.write(line.rstrip('\n') + (' 1' if flag else ' 0') + '\n')

        print(f'Written {len(self.set_val)} new files in {dir_out}')
        print(f'Saved {n_pos} positive and {n_neg} negative annotations')

    def _phase_of(self, gt_name):
        if gt_name in self.set_train:
            return 'train'
        if gt_name in self.set_val:
            return 'val'
        return None


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
