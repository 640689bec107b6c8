"""IoU matrix and greedy box matching (numpy, host).

Copied from `monoloco_tpu/geometry/iou.py` (what `Loco.post_process`,
GenerateKitti and EvalKitti call) so the port never imports the JAX package.
The matchers keep the reference's ordering rules: `get_iou_matches` visits
detections in descending confidence and the first to claim a ground truth
keeps it; `get_iou_matches_matrix` takes the largest remaining IoU first.
"""

import json

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


get_iou_matrix = iou_matrix


def calculate_iou(box1, box2):
    """IoU of two boxes [x1, y1, x2, y2]."""
    return float(iou_matrix([box1], [box2])[0, 0])


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


def get_iou_matches_matrix(boxes, boxes_gt, thresh):
    """Global-max greedy matching: repeatedly take the largest remaining IoU
    above thresh, zeroing its row and column."""
    mat = iou_matrix(boxes, boxes_gt)
    if mat.size == 0:
        return []
    mat = mat.copy()
    matches = []
    while True:
        flat = int(np.argmax(mat))
        i, j = np.unravel_index(flat, mat.shape)
        if mat[i, j] <= thresh:
            break
        matches.append((int(i), int(j)))
        mat[i, :] = 0.0
        mat[:, j] = 0.0
    return matches


def reorder_matches(matches, boxes, mode='left_right'):
    """Reorder (det, gt) matches by the left-right position of detections in the
    image."""
    assert mode == 'left_right'
    order = np.argsort([box[0] for box in boxes])
    det_idxs = [int(idx) for idx, _ in matches]
    return [matches[det_idxs.index(int(i))] for i in order if int(i) in det_idxs]


def get_category(keypoints, path_byc):
    """Pedestrian-vs-cyclist flags by intersecting lower-body boxes with bike
    boxes. Returns one float per person (1.0 = cyclist)."""
    dic_byc = open_annotations(path_byc)
    boxes_byc = dic_byc['boxes'] if dic_byc else []
    boxes_ped = _lower_boxes(keypoints)
    matches = get_iou_matches_matrix(boxes_ped, boxes_byc, thresh=0.15) if boxes_byc else []
    matched_byc = set()
    for idx, idx_byc in matches:
        bp, bb = boxes_ped[idx], boxes_byc[idx_byc]
        w_p, w_b = bp[2] - bp[0], bb[2] - bb[0]
        c_p, c_b = (bp[2] + bp[0]) / 2, (bb[2] + bb[0]) / 2
        if abs(c_p - c_b) < min(w_p, w_b) / 4:
            matched_byc.add(idx)
    return [1.0 if i in matched_byc else 0.0 for i in range(len(boxes_ped))]


def _lower_boxes(keypoints):
    kps = np.asarray(keypoints, dtype=np.float64)
    return [
        [k[0, 9:].min(), k[1, 9:].min(), k[0, 9:].max(), k[1, 9:].max()]
        for k in kps
    ]


def open_annotations(path_ann):
    try:
        with open(path_ann, 'r') as f:
            return json.load(f)
    except FileNotFoundError:
        return []
