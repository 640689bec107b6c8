"""IoU matrix and greedy box matching for post-processing (numpy, host).

Copied from `monoloco_tpu/geometry/iou.py` (only what `Loco.post_process`
calls) so the port never imports the JAX package. The matchers keep the
reference's ordering rules: detections visit in descending confidence and the
first to claim a ground truth keeps it.
"""

import numpy as np


def _as_boxes(boxes):
    arr = np.asarray(boxes, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None]
    return arr[:, :4] if arr.size else arr.reshape(0, 4)


def iou_matrix(boxes, boxes_gt):
    """Pairwise IoU between two box sets. boxes (m, 4+), boxes_gt (n, 4). -> (m, n)."""
    a = _as_boxes(boxes)
    b = _as_boxes(boxes_gt)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union


def get_iou_matches(boxes, boxes_gt, iou_min=0.3):
    """Greedy confidence-ordered matching.

    Detections are visited in descending confidence (boxes[:, 4]); each takes its
    best-IoU ground truth if IoU >= iou_min and that gt is still free.
    Returns a list of (det_idx, gt_idx).
    """
    if len(boxes) == 0 or len(boxes_gt) == 0:
        return []
    ious = iou_matrix(boxes, boxes_gt)
    confs = [box[4] for box in boxes]
    order = list(np.argsort(confs))[::-1]
    matches, used = [], set()
    for idx in order:
        idx_gt = int(np.argmax(ious[idx]))
        if ious[idx, idx_gt] >= iou_min and idx_gt not in used:
            matches.append((int(idx), idx_gt))
            used.add(idx_gt)
    return matches


def reorder_matches(matches, boxes, mode='left_right'):
    """Reorder (det, gt) matches by the left-right position of detections in the
    image."""
    assert mode == 'left_right'
    order = np.argsort([box[0] for box in boxes])
    det_idxs = [int(idx) for idx, _ in matches]
    return [matches[det_idxs.index(int(i))] for i in order if int(i) in det_idxs]
