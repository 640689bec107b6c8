"""nuScenes preprocessing: devkit scenes -> joints and names JSON files. A
host copy of `monoloco_tpu/prep/preprocess_nu.py`.

It walks the scenes and samples over the 6 cameras, projects the 3D ground
truth boxes, makes spherical labels with normalized h/w/l, IoU-matches them
against the pifpaf detections and writes the joints/names schema of KITTI
prep (plus `boxes_3d`). The nuScenes devkit (and its pyquaternion) is
optional: `factory` imports it when a `PreprocessNuscenes` is built.
"""

import copy
import datetime
import json
import logging
import math
import os
import sys
import time
from collections import defaultdict

import numpy as np

from ..geometry import get_iou_matches
from ..geometry.host import correct_angle, np_preprocess_monoloco, project_3d, to_spherical
from ..network.preprocess import preprocess_pifpaf
from ..utils import append_cluster, normalize_hwl
from ..utils.nuscenes import select_categories


def quaternion_yaw(q, in_image_frame=True):
    """Yaw from a pyquaternion Quaternion (about the camera's y axis in the
    image frame, about z in the world frame)."""
    v = np.dot(q.rotation_matrix, np.array([1, 0, 0]))
    if in_image_frame:
        return float(-np.arctan2(v[2], v[0]))
    return float(np.arctan2(v[1], v[0]))


def extract_ground_truth(boxes_obj, kk, spherical=True):
    """nuScenes Box objects -> (2D boxes, 3D boxes, labels)."""
    boxes_gt, boxes_3d, ys = [], [], []
    for box_obj in boxes_obj:
        if box_obj.name[:6] != 'animal':
            general_name = '.'.join(box_obj.name.split('.')[:2])
        else:
            general_name = 'animal'
        if general_name not in select_categories('all'):
            continue
        boxes_gt.append(project_3d(box_obj, kk))
        boxes_3d.append(list(box_obj.center) + list(box_obj.wlh))
        yaw = quaternion_yaw(box_obj.orientation)
        assert -math.pi <= yaw <= math.pi
        sin, cos, _ = correct_angle(yaw, box_obj.center)
        hwl = [float(box_obj.wlh[i]) for i in (2, 0, 1)]
        xyz = list(box_obj.center)
        dd = float(np.linalg.norm(box_obj.center))
        if spherical:
            rtp = to_spherical(xyz)
            loc = rtp[1:3] + xyz[2:3] + rtp[0:1]
        else:
            loc = xyz + [dd]
        ys.append(loc + hwl + [sin, cos, yaw])
    return boxes_gt, boxes_3d, ys


def factory(dataset, dir_nuscenes, dir_splits='splits'):
    """Instantiate the devkit and resolve train/val scene splits."""
    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    assert dataset in ('nuscenes', 'nuscenes_mini', 'nuscenes_teaser')
    version = 'v1.0-mini' if dataset == 'nuscenes_mini' else 'v1.0-trainval'
    nusc = NuScenes(version=version, dataroot=dir_nuscenes, verbose=True)
    scenes = nusc.scene

    if dataset == 'nuscenes_teaser':
        with open(os.path.join(dir_splits, 'nuscenes_teaser_scenes.txt'), 'r') as f:
            teaser_scenes = f.read().splitlines()
        scenes = [s for s in scenes if s['token'] in teaser_scenes]
        with open(os.path.join(dir_splits, 'split_nuscenes_teaser.json'), 'r') as f:
            dic_split = json.load(f)
        split_train = [s['name'] for s in scenes if s['token'] in dic_split['train']]
        split_val = [s['name'] for s in scenes if s['token'] in dic_split['val']]
    else:
        split_scenes = splits.create_splits_scenes()
        split_train, split_val = split_scenes['train'], split_scenes['val']
    return nusc, scenes, split_train, split_val


class PreprocessNuscenes:
    """Walk nuScenes scenes and build the joints/names training JSONs."""

    CAMERAS = ('CAM_FRONT', 'CAM_FRONT_LEFT', 'CAM_FRONT_RIGHT',
               'CAM_BACK', 'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

    def __init__(self, dir_ann, dir_nuscenes, dataset, iou_min):
        logging.basicConfig(level=logging.INFO)
        self.logger = logging.getLogger(__name__)
        self.iou_min = iou_min
        self.dir_ann = dir_ann
        dir_out = os.path.join('data', 'arrays')
        os.makedirs(dir_out, exist_ok=True)
        assert os.path.exists(dir_nuscenes), "Nuscenes directory does not exist"
        assert os.path.exists(self.dir_ann), "The annotations directory does not exist"

        now_time = datetime.datetime.now().strftime("%Y%m%d-%H%M")[2:]
        self.path_joints = os.path.join(dir_out, f'joints-{dataset}-{now_time}.json')
        self.path_names = os.path.join(dir_out, f'names-{dataset}-{now_time}.json')
        self.nusc, self.scenes, self.split_train, self.split_val = factory(
            dataset, dir_nuscenes)

        def phase_dict():
            return dict(X=[], Y=[], names=[], kps=[], boxes_3d=[], K=[],
                        clst=defaultdict(lambda: defaultdict(list)))
        self.dic_jo = {'train': phase_dict(), 'val': phase_dict(), 'test': phase_dict()}
        self.dic_names = defaultdict(lambda: defaultdict(list))

    def run(self):
        cnt_scenes = cnt_samples = cnt_sd = cnt_ann = 0
        start = time.time()
        for scene in self.scenes:
            current_token = scene['first_sample_token']
            cnt_scenes += 1
            sys.stdout.write(f'\rElaborating scene {cnt_scenes}\t\n')
            if scene['name'] in self.split_train:
                phase = 'train'
            elif scene['name'] in self.split_val:
                phase = 'val'
            else:
                print("phase name not in training or validation split")
                continue

            while current_token != "":
                sample_dic = self.nusc.get('sample', current_token)
                cnt_samples += 1
                for cam in self.CAMERAS:
                    sd_token = sample_dic['data'][cam]
                    cnt_sd += 1
                    path_im, boxes_obj, kk = self.nusc.get_sample_data(
                        sd_token, box_vis_level=1)
                    boxes_gt, boxes_3d, ys = extract_ground_truth(boxes_obj, kk)
                    kk = kk.tolist()
                    name = os.path.basename(path_im)
                    basename, _ = os.path.splitext(name)

                    self.dic_names[basename + '.jpg']['boxes'] = copy.deepcopy(boxes_gt)
                    self.dic_names[basename + '.jpg']['ys'] = copy.deepcopy(ys)
                    self.dic_names[basename + '.jpg']['K'] = copy.deepcopy(kk)

                    path_pif = os.path.join(self.dir_ann, name + '.predictions.json')
                    if not os.path.isfile(path_pif):
                        continue
                    with open(path_pif, 'r') as file:
                        annotations = json.load(file)
                    boxes, keypoints = preprocess_pifpaf(annotations, im_size=(1600, 900))
                    if not keypoints:
                        continue
                    matches = get_iou_matches(boxes, boxes_gt, self.iou_min)
                    for (idx, idx_gt) in matches:
                        keypoint = keypoints[idx:idx + 1]
                        inp = np_preprocess_monoloco(
                            np.asarray(keypoint), kk).reshape(-1).tolist()
                        lab = normalize_hwl(ys[idx_gt])
                        self.dic_jo[phase]['kps'].append(keypoint)
                        self.dic_jo[phase]['X'].append(inp)
                        self.dic_jo[phase]['Y'].append(lab)
                        self.dic_jo[phase]['names'].append(name)
                        self.dic_jo[phase]['boxes_3d'].append(boxes_3d[idx_gt])
                        self.dic_jo[phase]['K'].append(kk)
                        append_cluster(self.dic_jo, phase, inp, lab, keypoint)
                        cnt_ann += 1
                        sys.stdout.write(f'\rSaved annotations {cnt_ann}\t')
                current_token = sample_dic['next']

        with open(self.path_joints, 'w') as f:
            json.dump(self.dic_jo, f)
        with open(self.path_names, 'w') as f:
            json.dump(self.dic_names, f)
        end = time.time()
        print(f"\nSaved {cnt_ann} annotations for {cnt_samples} samples in "
              f"{cnt_scenes} scenes. Total time: {(end - start) / 60:.1f} minutes")
        print(f"\nOutput files:\n{self.path_names}\n{self.path_joints}\n")


def extract_social(inputs, ys, keypoints, idx, matches):
    """Pad one person's inputs with their 2 nearest neighbours' relative ground
    foot + gt depth (the experimental social branch). Returns a 38-dim list."""
    all_inputs = []
    ground_foot = np.max(np.array(inputs)[:, [31, 33]], axis=1)
    rel_ground_foot = (ground_foot - ground_foot[idx]).tolist()

    base = np.array([np.mean(np.array(keypoints[idx][0])),
                     np.mean(np.array(keypoints[idx][1]))])
    delta_input = [np.linalg.norm(base - np.array([np.mean(np.array(kp[0])),
                                                   np.mean(np.array(kp[1]))]))
                   for kp in keypoints]
    sorted_indices = sorted(range(len(delta_input)), key=lambda k: delta_input[k])
    all_inputs.extend(inputs[idx])

    indices_idx = [i for (i, _) in matches]
    for ii in range(1, 3):
        try:
            index = sorted_indices[ii]
            try:
                idx_gt = matches[indices_idx.index(index)][1]
                all_inputs.append(rel_ground_foot[index])
                all_inputs.append(float(ys[idx_gt][3]))
            except ValueError:
                all_inputs.extend([0.] * 2)
        except IndexError:
            all_inputs.extend([0.] * 2)
    assert len(all_inputs) == 34 + 2 * 2
    return all_inputs
