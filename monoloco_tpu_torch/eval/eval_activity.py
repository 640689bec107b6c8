"""Activity evaluation (`eval --activity`): talking on the Collective
Activity Dataset and social distancing on KITTI's `gt_activity` files. The
port of `monoloco_tpu/eval/eval_activity.py`.

Per frame: the pifpaf poses, one `Loco.forward` on the engine's device (its
MLP under MONOLOCO_TPU_PRECISION: a frame of 9 or more detections pads to 16
rows, where int8 routes to the dyn8 kernel), post-processing, IoU matching
to the ground truth, and the F-formation rule of `activity.py` for each
matched person; accuracy and recall per tag (sequence or KITTI difficulty)
and overall. The image size of a Collective sequence comes from its first
JPEG's header (`predict.image_size`), so Pillow is not needed.
"""

import csv
import glob
import os
from collections import defaultdict

import numpy as np

from ..activity import social_interactions
from ..geometry import get_iou_matches, open_annotations
from ..network import Loco, load_calibration, preprocess_pifpaf
from ..predict import image_size
from ..prep import factory_file
from ..utils import get_difficulty

# Per-dataset evaluation settings. Collective Activity scores the "talking"
# label with the deterministic F-formation rule; KITTI scores the augmented
# social-distance flag with the third o-space radius enabled.
_SETTINGS = {
    'collective': dict(threshold_prob=0.25, threshold_dist=2, radii=(0.3, 0.5),
                       pifpaf_conf=0.3, social_distance=False,
                       data_dir=os.path.join('data', 'activity', 'dataset')),
    'kitti': dict(threshold_prob=0.25, threshold_dist=2, radii=(0.3, 0.5, 1),
                  pifpaf_conf=0.3, social_distance=True,
                  data_dir=os.path.join('data', 'kitti', 'gt_activity')),
}

DEFAULT_SEQUENCES = ('seq02', 'seq14', 'seq12', 'seq13', 'seq11', 'seq36')


def accuracy_score(y_true, y_pred):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0:
        return float('nan')
    return float(np.mean(y_true == y_pred))


class ActivityEvaluator:
    """Evaluate talking activity (Collective Activity) and social distancing (KITTI)."""

    def __init__(self, args):
        assert args.dataset in _SETTINGS, "dataset not recognized"
        assert args.dir_ann is not None and os.path.exists(args.dir_ann), \
            "Annotation directory not provided / does not exist"
        assert os.listdir(args.dir_ann), "Annotation directory is empty"
        self.dir_ann = args.dir_ann
        self.dataset = args.dataset
        self.cfg = _SETTINGS[args.dataset]
        self.dir_data = self.cfg['data_dir']
        self.sequences = list(DEFAULT_SEQUENCES)
        self.dir_kk = os.path.join('data', 'kitti', 'calib')

        device = 'cpu' if getattr(args, 'disable_cuda', False) else None
        self.monoloco = Loco(model=args.model, mode=args.mode, device=device,
                             n_dropout=args.n_dropout, p_dropout=args.dropout)
        # predictions/ground truth accumulated per tag ('all', sequence name,
        # or KITTI difficulty), plus counters for the recall denominator.
        self.all_pred = defaultdict(list)
        self.all_gt = defaultdict(list)
        self.cnt = {'pred': defaultdict(int), 'gt': defaultdict(int)}

    # ------------------------------------------------------------------

    def eval_collective(self):
        for seq in self.sequences:
            first = os.path.join(self.dir_data, 'images', seq + '_frame0001.jpg')
            im_size = tuple(image_size(first))
            kk = load_calibration(calibration='kitti', im_size=im_size)
            gt_by_frame = self._load_collective_gt(seq)
            for im_path in glob.glob(os.path.join(self.dir_data, 'images',
                                                  seq + '*.jpg')):
                name = os.path.basename(im_path)
                annotations = open_annotations(
                    os.path.join(self.dir_ann, name + '.predictions.json'))
                frame = gt_by_frame[_frame_key(name)]
                self._eval_frame(annotations, kk, im_size, frame['boxes'],
                                 np.array(frame['y']), tags=[seq] * len(frame['boxes']))
            print(f"Accuracy of category {seq}: "
                  f"{100 * accuracy_score(self.all_gt[seq], self.all_pred[seq]):.2f}%")
        self._summarize(self.sequences)

    def eval_kitti(self):
        files = glob.glob(self.dir_data + '/*.txt')
        assert files, "Empty directory"
        for path_gt in files:
            basename, _ = os.path.splitext(os.path.basename(path_gt))
            annotations, kk, _ = factory_file(
                os.path.join(self.dir_kk, basename + '.txt'), self.dir_ann, basename)
            boxes_gt, ys_gt, tags = self._load_kitti_activity_gt(path_gt)
            self._eval_frame(annotations, kk, (1242, 374), boxes_gt, ys_gt, tags)
        self._summarize(('easy', 'moderate', 'hard'))

    # ------------------------------------------------------------------

    def _eval_frame(self, annotations, kk, im_size, boxes_gt, ys_gt, tags):
        """Forward one frame, match to gt, and score each matched person."""
        boxes, keypoints = preprocess_pifpaf(
            annotations, im_size, enlarge_boxes=True,
            min_conf=self.cfg['pifpaf_conf'])
        dic_out = self.monoloco.forward(keypoints, kk)
        dic_out = self.monoloco.post_process(dic_out, boxes, keypoints, kk,
                                             dic_gt=None, reorder=False,
                                             verbose=False)
        for tag in tags:
            self.cnt['gt'][tag] += 1
            self.cnt['gt']['all'] += 1

        ground_xz = [[p[0], p[2]] for p in dic_out['xyz_pred']]
        for det_idx, gt_idx in get_iou_matches(boxes, boxes_gt, iou_min=0.3):
            flag = social_interactions(
                det_idx, ground_xz, dic_out['angles'], dic_out['dds_pred'],
                stds=dic_out['stds_ale'],
                threshold_prob=self.cfg['threshold_prob'],
                threshold_dist=self.cfg['threshold_dist'],
                radii=self.cfg['radii'],
                social_distance=self.cfg['social_distance'])
            for tag in ('all', tags[gt_idx]):
                self.all_pred[tag].append(flag)
                self.all_gt[tag].append(ys_gt[gt_idx])
                self.cnt['pred'][tag] += 1

    # ------------------------------------------------------------------

    def _load_collective_gt(self, seq):
        """Collective Activity annotations, grouped by frame key
        (category 6 == talking)."""
        path = os.path.join(self.dir_data, 'annotations', seq + '_annotations.txt')
        by_frame = defaultdict(lambda: defaultdict(list))
        with open(path, 'r') as f:
            for row in csv.reader(f, delimiter='\t'):
                x, y, w, h = (float(v) for v in row[1:5])
                by_frame[row[0]]['boxes'].append([x, y, x + w, y + h])
                by_frame[row[0]]['y'].append(1 if row[5] == '6' else 0)
        return by_frame

    @staticmethod
    def _load_kitti_activity_gt(path_gt):
        """gt_activity txt: KITTI line + trailing social-distance flag."""
        boxes, flags, tags = [], [], []
        with open(path_gt, 'r') as f:
            for raw in f:
                fields = raw.split()
                box = [float(v) for v in fields[4:8]]
                flag = int(fields[-1])
                assert flag in (0, 1), "Expected to be binary (1/0)"
                boxes.append(box)
                flags.append(flag)
                tags.append(get_difficulty(box, float(fields[1]), int(fields[2])))
        return boxes, flags, tags

    def _summarize(self, tags):
        print('-' * 80)
        for tag in list(tags) + ['all']:
            if not self.all_gt[tag]:
                continue
            recall = self.cnt['pred'][tag] / max(self.cnt['gt'][tag], 1)
            print(f"Accuracy of category {tag}: "
                  f"{100 * accuracy_score(self.all_gt[tag], self.all_pred[tag]):.2f}% , "
                  f"Recall: {100 * recall:.2f}%, #: {self.cnt['pred'][tag]}, "
                  f"Pred/Real positive: "
                  f"{100 * sum(self.all_pred[tag]) / len(self.all_pred[tag]):.1f}% / "
                  f"{100 * sum(self.all_gt[tag]) / len(self.all_gt[tag]):.1f}%")
        final_acc = accuracy_score(self.all_gt['all'], self.all_pred['all'])
        final_recall = 100 * self.cnt['pred']['all'] / max(self.cnt['gt']['all'], 1)
        print('-' * 80)
        print(f"Final Accuracy: {final_acc * 100:.2f}      "
              f"Final Recall:{final_recall:.2f}")
        print('-' * 80)


def _frame_key(image_name):
    """seqXX_frameNNNN.jpg -> the frame key used by the annotation files."""
    if image_name[11] == '0':
        return image_name[12:15]
    return image_name[11:15]
