"""Small shared helpers: a host copy of `monoloco_tpu/utils/misc.py`, so the
port never imports the JAX package (whose `utils/__init__.py` pulls in jax)."""

import os
import shutil

import numpy as np

# Distance-bin edges used to cluster training annotations (misc.py:7-29).
CLUSTER_EDGES = (10, 20, 30, 40)

# Average pedestrian dimensions and their normalization std (misc.py:54-64).
AV_H, AV_W, AV_L = 1.72, 0.75, 0.68
HWL_STD = 0.1


def append_cluster(dic_jo, phase, xx, ys, kps):
    """Bin one training annotation by its gt distance ys[3] into the clst dict."""
    dd = ys[3]
    for edge in CLUSTER_EDGES:
        if dd <= edge:
            clst = str(edge)
            break
    else:
        clst = '>40'
    dic_jo[phase]['clst'][clst]['kps'].append(kps)
    dic_jo[phase]['clst'][clst]['X'].append(xx)
    dic_jo[phase]['clst'][clst]['Y'].append(ys)


def get_task_error(dd):
    """Monocular analytic error floor from human-height variation: 0.046*d."""
    return dd * 0.046


def get_pixel_error(zz_gt):
    """Stereo error floor for a 1-pixel disparity mismatch at depth zz_gt."""
    disp = 0.54 * 721 / zz_gt
    return abs(zz_gt - 0.54 * 721 / (disp - 1))


def make_new_directory(dir_out):
    """Recreate an empty output directory (avoids stale txt files)."""
    if os.path.exists(dir_out):
        shutil.rmtree(dir_out)
    os.makedirs(dir_out)
    print(f"Created empty output directory {dir_out} ")


def normalize_hwl(lab):
    """Normalize label h/w/l by the average-pedestrian stats (misc.py:54-64)."""
    hwl_new = list((np.array(lab[4:7]) - np.array([AV_H, AV_W, AV_L])) / HWL_STD)
    return lab[0:4] + hwl_new + lab[7:]


def average(my_list):
    return sum(my_list) / len(my_list)
