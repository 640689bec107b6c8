"""Input preprocessing: keypoints -> normalized model inputs; calibration;
pifpaf IO.

`preprocess_monoloco` runs on the device in torch; the rest is host-side data
wrangling, copied from `monoloco_tpu/network/preprocess.py`: the
calibration, the pifpaf and Mask-R-CNN keypoint files, and the ImageNet
normalization of an image (`image_transform`). The calibration
presets of the JAX package's `intrinsics.yaml` are a dict here, so the port
needs no yaml.
"""

import json
import logging
import os

import numpy as np
import torch

# get_keypoints is importable from here, as from the JAX package's module.
from ..geometry import get_keypoints, open_annotations, pixel_to_camera  # noqa: F401

logger = logging.getLogger(__name__)

# nuScenes-style sensor size (mm) for the 'custom' calibration preset.
SENSOR_SX = 7.2
SENSOR_SY = 5.4

# The JAX package's network/intrinsics.yaml.
INTRINSICS = {
    'kitti': {'intrinsics': [[718.3351, 0., 600.3891],
                             [0., 718.3351, 181.5122],
                             [0., 0., 1.]],
              'im_size': [1238, 374]},
    'wv': {'intrinsics': [[1070.9498, 0., 987.4846],
                          [0., 1070.726, 605.5297],
                          [0., 0., 1.]],
           'im_size': [1920, 1200]},
    'nuscenes': {'intrinsics': [[1070.9498, 0., 987.4846],
                                [0., 1070.726, 605.5297],
                                [0., 0., 1.]],
                 'im_size': [1600, 900]},
}


def preprocess_monoloco(keypoints, kk, zero_center=False):
    """Keypoints (..., m, 3, 17) -> model inputs (..., m, 34).

    Back-projects pixel keypoints through K^-1 at z=10 and flattens the xy
    channels. kk is (3, 3), or (B, 3, 3) for a (B, m, 3, 17) image batch (the
    JAX package's vmap over images). `zero_center` subtracts the
    back-projected box center (legacy monoloco net only).
    """
    kps = torch.as_tensor(keypoints, dtype=torch.float32)
    kk = torch.as_tensor(kk, dtype=torch.float32, device=kps.device)
    if kps.ndim == 2:
        kps = kps[None]
    if kk.ndim == 3:
        kk = kk[:, None]                                   # (B, 1, 3, 3)
    xy1_all = pixel_to_camera(kps[..., 0:2, :], kk, 10)    # (..., m, 17, 3)
    if zero_center:
        xy = kps[..., 0:2, :]
        uv_center = (xy.amax(dim=-1) + xy.amin(dim=-1)) / 2.0     # (..., m, 2)
        xy1_all = xy1_all - pixel_to_camera(uv_center[..., None, :], kk, 10)
    return xy1_all[..., 0:2].reshape(xy1_all.shape[:-2] + (-1,))


def preprocess_monstereo(keypoints, keypoints_r, kk):
    """All-vs-all stereo pairing: (..., m, 3, 17) x (..., r, 3, 17) ->
    ((..., m*r, 68), clusters).

    Row i*r+j is [inp_l_i, inp_l_i - inp_r_j]; `clusters` lists r per left
    pose. With a leading image axis B (kk (B, 3, 3)) each image pairs its own
    poses, as the JAX package's vmap over images does.
    """
    inp_l = preprocess_monoloco(keypoints, kk)              # (..., m, 34)
    inp_r = preprocess_monoloco(keypoints_r, kk)            # (..., r, 34)
    m, r = inp_l.shape[-2], inp_r.shape[-2]
    lead = inp_l.shape[:-2]
    left = inp_l[..., :, None, :].expand(lead + (m, r, 34))
    diff = inp_l[..., :, None, :] - inp_r[..., None, :, :]
    inputs = torch.cat([left, diff], dim=-1).reshape(lead + (m * r, 68))
    return inputs, [r] * m


def load_calibration(calibration, im_size, focal_length=5.7):
    """Build a 3x3 intrinsics matrix (list of lists).

    'custom' derives K from focal length (mm) and the nuScenes sensor size;
    named presets come from INTRINSICS rescaled to the image size.
    """
    if calibration == 'custom':
        kk = [
            [im_size[0] * focal_length / SENSOR_SX, 0., im_size[0] / 2],
            [0., im_size[1] * focal_length / SENSOR_SY, im_size[1] / 2],
            [0., 0., 1.],
        ]
    else:
        preset = INTRINSICS[calibration]
        kk = [list(row) for row in preset['intrinsics']]
        scale = [size / orig for size, orig in zip(im_size, preset['im_size'])]
        kk[0] = [el * scale[0] for el in kk[0]]
        kk[1] = [el * scale[1] for el in kk[1]]
    logger.info("Using %s calibration matrix", calibration)
    return kk


def factory_for_gt(path_gt, name=None):
    """Load ground-truth dict + calibration for one image from a names-json."""
    assert os.path.exists(path_gt), "Ground-truth file not found"
    with open(path_gt, 'r') as f:
        dic_names = json.load(f)
    dic_gt = dic_names[name]
    return dic_gt, dic_gt['K']


def prepare_pif_kps(kps_in):
    """Flat list of 51 (x, y, c triplets) -> [xs(17), ys(17), confs(17)]."""
    assert len(kps_in) % 3 == 0, "keypoints expected as a multiple of 3"
    return [kps_in[0::3], kps_in[1::3], kps_in[2::3]]


def preprocess_pifpaf(annotations, im_size=None, enlarge_boxes=True, min_conf=0.):
    """Adapt pifpaf annotation dicts: enlarge the bbox, clamp to the image,
    filter by confidence.

    Returns (boxes [x1, y1, x2, y2, conf], keypoints [3][17]) lists.
    """
    boxes, keypoints = [], []
    enlarge = 1 if enlarge_boxes else 2  # halve the margin for social distancing

    for dic in annotations:
        kps = prepare_pif_kps(dic['keypoints'])
        box = list(dic['bbox'])
        try:
            conf = dic['score']
            delta_h = box[3] / (10 * enlarge)
            delta_w = box[2] / (5 * enlarge)
            box[2] += box[0]
            box[3] += box[1]
        except KeyError:
            all_confs = np.array(kps[2])
            conf = float(np.mean(all_confs))
            delta_h = (box[3] - box[1]) / (7 * enlarge)
            delta_w = (box[2] - box[0]) / (3.5 * enlarge)
            assert delta_h > -5 and delta_w > -5, "Bounding box <=0"

        box[0] -= delta_w
        box[1] -= delta_h
        box[2] += delta_w
        box[3] += delta_h

        if im_size is not None:
            box[0] = max(0, box[0])
            box[1] = max(0, box[1])
            box[2] = min(box[2], im_size[0])
            box[3] = min(box[3], im_size[1])

        if conf >= min_conf:
            box.append(conf)
            boxes.append(box)
            keypoints.append(kps)

    return boxes, keypoints


def preprocess_mask(dir_ann, basename, mode='left'):
    """Mask-R-CNN keypoint annotations of one image from the 'mask'
    directory beside `dir_ann` ('mask_right' for mode 'right'). Returns
    (boxes, keypoints [3][17]); a missing file, or one holding a list,
    gives ([], [])."""
    dir_mask = os.path.join(os.path.split(dir_ann)[0], 'mask')
    if mode == 'left':
        path_ann = os.path.join(dir_mask, basename + '.json')
    else:
        assert mode == 'right'
        path_ann = os.path.join(dir_mask + '_right', basename + '.json')
    dic = open_annotations(path_ann)
    if isinstance(dic, list):
        return [], []
    keypoints = [prepare_pif_kps(np.asarray(kps).reshape(51).tolist())
                 for kps in dic['keypoints']]
    return dic['boxes'], keypoints


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def image_transform(image):
    """An RGB image (anything `np.asarray` takes: an (h, w, 3) uint8 array,
    a Pillow image) as a (3, h, w) float32 array, scaled to [0, 1] and
    normalized by the ImageNet mean and std."""
    arr = np.asarray(image, dtype=np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(arr, (2, 0, 1))
