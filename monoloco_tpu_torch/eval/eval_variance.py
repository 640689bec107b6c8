"""Keypoint-disparity variance study (`eval --variance`, MonStereo's
supplementary analysis): a host copy of `monoloco_tpu/eval/eval_variance.py`.

Per distance cluster, the statistics of the stereo keypoint disparities of
`<joints>_pifpaf.json` and `<joints>_mask.json`: disparity std, the depth
deviation of the median disparity, confidence-ranked subsets, per-joint
repeatability (|disp - BF/z| < 1 px); and the summary figure
`figures/joints_variance.png` (matplotlib, imported inside
`variance_figures`).
"""

import json
import os
from collections import defaultdict

import numpy as np

from ..utils import find_cluster, average

BF = 0.54 * 721
DEFAULT_CLUSTERS = ('3', '5', '7', '9', '11', '13', '15', '17', '19', '21',
                    '23', '25', '27', '29', '31', '49')


def get_variance(kps, kps_r, zz):
    """Up-to-3 disparities with confidence above a depth-dependent threshold
    (skipping the largest disparity), falling back to all."""
    thresh = 0.5 - zz / 100
    disps = kps[0] - kps_r[0]
    arg_disp = np.argsort(disps)[::-1]
    selected = []
    for idx in arg_disp[1:]:
        if kps[2][idx] > thresh and kps_r[2][idx] > thresh:
            selected.append(disps[idx])
        if len(selected) >= 3:
            return np.array(selected)
    return disps


def get_variance_conf(kps, kps_r, num=8):
    """Disparities of the `num` most confident joints."""
    confs = (kps[2, :] + kps_r[2, :]) / 2
    disps = kps[0] - kps_r[0]
    arg_disp = np.argsort(confs)[::-1]
    return np.array([disps[idx] for idx in arg_disp[:num]])


def joints_variance(joints, clusters=None, dic_ms=None, phase='train'):
    """Analyze stereo joints files `<joints>_pifpaf.json` / `<joints>_mask.json`."""
    clusters = tuple(clusters) if clusters else DEFAULT_CLUSTERS
    methods = ('pifpaf', 'mask')
    dic_fin = {}

    for method in methods:
        path_joints = joints + '_' + method + '.json'
        if not os.path.exists(path_joints):
            print(f"Variance study: {path_joints} not found, skipping {method}")
            continue
        with open(path_joints, 'r') as f:
            dic_jo = json.load(f)

        dic_var = defaultdict(lambda: defaultdict(list))
        dic_joints = defaultdict(list)
        dic_avg = defaultdict(lambda: defaultdict(float))

        for idx, keypoint in enumerate(dic_jo[phase]['kps']):
            kps = np.array(keypoint[0])[:, :17]
            kps_r = np.array(keypoint[0])[:, 17:]
            disps = kps[0] - kps_r[0]
            zz = dic_jo[phase]['Y'][idx][2]
            disps_3 = get_variance(kps, kps_r, zz)
            disps_8 = get_variance_conf(kps, kps_r, num=8)
            disps_4 = get_variance_conf(kps, kps_r, num=4)
            disp_gt = BF / zz
            clst = find_cluster(zz, clusters)
            dic_var['std_d'][clst].append(disps.std())
            errors = np.minimum(30, np.abs(zz - BF / disps))
            dic_var['mean_dev'][clst].append(min(30, abs(zz - BF / np.median(disps))))
            dic_var['mean_3'][clst].append(min(30, abs(zz - BF / disps_3.mean())))
            dic_var['mean_8'][clst].append(min(30, abs(zz - BF / np.median(disps_8))))
            dic_var['mean_4'][clst].append(min(30, abs(zz - BF / np.median(disps_4))))
            arg_best = int(np.argmin(errors))
            conf = np.mean((kps[2][arg_best], kps_r[2][arg_best]))
            dic_var['mean_best'][clst].append(float(np.min(errors)))
            dic_var['conf_best'][clst].append(conf)
            dic_var['conf'][clst].append(np.mean((np.mean(kps[2]), np.mean(kps_r[2]))))
            for ii, el in enumerate(disps):
                flag = 1 if abs(el - disp_gt) < 1 else 0
                dic_var['rep'][clst].append(flag)
                dic_joints[str(ii)].append(flag)

        for key in dic_var:
            for clst in clusters[:-1]:
                if dic_var[key][clst]:
                    dic_avg[key][clst] = average(dic_var[key][clst])
        dic_fin[method] = dic_avg
        dic_fin[method]['joints'] = {k: average(v) for k, v in dic_joints.items()}

    if dic_ms is not None:
        dic_fin['monstereo'] = {clst: dic_ms[clst]['mean'] for clst in clusters[:-1]}
    if dic_fin:
        try:
            variance_figures(dic_fin, clusters)
        except ImportError as exc:          # no matplotlib: the statistics alone
            print(f"Variance study: no figure written ({exc})")
    return dic_fin


def variance_figures(dic_fin, clusters, dir_out='figures'):
    """Repeatability / deviation curves per distance cluster."""
    from ..visuals.figures import get_distances
    from ..visuals.pifpaf_show import _pyplot
    plt = _pyplot()

    os.makedirs(dir_out, exist_ok=True)
    xxs = get_distances(clusters)

    fig, ax = plt.subplots(1, 2, figsize=(12, 5))
    for method, marker in (('pifpaf', 'o'), ('mask', 's')):
        if method not in dic_fin:
            continue
        rep = [dic_fin[method]['rep'].get(clst, np.nan) for clst in clusters[:-1]]
        dev = [dic_fin[method]['mean_dev'].get(clst, np.nan) for clst in clusters[:-1]]
        n = min(len(xxs), len(rep))
        ax[0].plot(xxs[:n], rep[:n], marker=marker, label=method)
        ax[1].plot(xxs[:n], dev[:n], marker=marker, label=method)
    ax[0].set_xlabel('Ground-truth distance [m]')
    ax[0].set_ylabel('Joint repeatability')
    ax[1].set_xlabel('Ground-truth distance [m]')
    ax[1].set_ylabel('Median-disparity depth error [m]')
    for a in ax:
        a.legend()
        a.grid(alpha=0.3)
    path = os.path.join(dir_out, 'joints_variance.png')
    fig.savefig(path, bbox_inches='tight')
    plt.close(fig)
    print(f'Saved figure {path}')
