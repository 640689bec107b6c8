"""KITTI file parsing and split handling: a host copy of
`monoloco_tpu/utils/kitti.py` (the port never imports the JAX package)."""

import glob
import os

import numpy as np

# Files the reference removes from the training split (utils/kitti.py:122-124).
_BAD_TRAIN_FILES = ('000518.txt', '005692.txt', '003009.txt')


def get_calibration(path_txt):
    """Parse a KITTI calib txt: P2 (left cam) and P3 (right cam) -> ([K, t], [K_r, t_r])."""
    with open(path_txt, 'r') as ff:
        lines = ff.readlines()
    p2 = np.array([float(x) for x in lines[2].split()[1:]]).reshape(3, 4)
    p3 = np.array([float(x) for x in lines[3].split()[1:]]).reshape(3, 4)
    return list(get_translation(p2)), list(get_translation(p3))


def get_translation(pp):
    """Split a 3x4 projection into intrinsics K (list) and translation t
    (utils/kitti.py:45-56, including its x0,y0 = K[2,0:2] convention)."""
    kk = pp[:, :-1]
    f_x, f_y = kk[0, 0], kk[1, 1]
    x0, y0 = kk[2, 0:2]
    aa, bb, t3 = pp[0:3, 3]
    t1 = float((aa - x0 * t3) / f_x)
    t2 = float((bb - y0 * t3) / f_y)
    return kk.tolist(), [t1, t2, float(t3)]


def get_simplified_calibration(path_txt):
    with open(path_txt, 'r') as ff:
        for line in ff:
            if line[:4] == 'K_02':
                kk_list = [float(x) for x in line[4:].split()[1:]]
                return np.array(kk_list).reshape(3, 3).tolist()
    raise ValueError('Matrix K_02 not found in the file')


def check_conditions(line, category, method, thresh=0.3):
    """Filter a gt/method annotation line by category (and confidence for
    methods) — utils/kitti.py:74-91. For methods, `line` is a split list."""
    assert category in ('pedestrian', 'cyclist', 'all')
    cats = ('pedestrian', 'person_sitting', 'cyclist') if category == 'all' else (category,)
    if method == 'gt':
        return line.split()[0].lower() in cats
    conf = float(line[15])
    return line[0].lower() in cats and conf >= thresh


def get_difficulty(box, trunc, occ):
    """KITTI easy/moderate/hard bins by bbox height, truncation, occlusion."""
    hh = box[3] - box[1]
    if hh >= 40 and trunc <= 0.15 and occ <= 0:
        return 'easy'
    if trunc <= 0.3 and occ <= 1 and hh >= 25:
        return 'moderate'
    if trunc <= 0.5 and occ <= 2 and hh >= 25:
        return 'hard'
    return 'excluded'


def split_training(names_gt, path_train, path_val):
    """Intersect available gt files with the train/val split lists."""
    set_gt = set(names_gt)
    set_train, set_val = set(), set()
    with open(path_train, 'r') as f:
        for line in f:
            set_train.add(line.strip() + '.txt')
    with open(path_val, 'r') as f:
        for line in f:
            set_val.add(line.strip() + '.txt')
    set_train = set_gt.intersection(set_train)
    for bad in _BAD_TRAIN_FILES:
        set_train.discard(bad)
    set_val = tuple(set_gt.intersection(set_val))
    set_train = tuple(set_train)
    assert set_train and set_val, "No validation or training annotations"
    return set_train, set_val


def factory_basename(dir_ann, dir_gt, dir_splits='splits'):
    """Basenames in the annotation folder that belong to the validation split."""
    names_gt = tuple(os.listdir(dir_gt))
    path_train = os.path.join(dir_splits, 'kitti_train.txt')
    path_val = os.path.join(dir_splits, 'kitti_val.txt')
    _, set_val_gt = split_training(names_gt, path_train, path_val)
    set_val_gt = {os.path.basename(x).split('.')[0] for x in set_val_gt}
    list_ann = glob.glob(os.path.join(dir_ann, '*.json'))
    set_basename = {os.path.basename(x).split('.')[0] for x in list_ann}
    set_val = set_basename.intersection(set_val_gt)
    assert set_val, "Missing json annotations file to create txt files for KITTI datasets"
    return set_val


def read_and_rewrite(path_orig, path_new):
    """Copy a gt txt file, truncating h/w/l to 4 chars (utils/kitti.py:149-165);
    create an empty file if the source is missing."""
    try:
        with open(path_orig, 'r') as f_gt, open(path_new, 'w+') as ff:
            for line_gt in f_gt:
                line = line_gt.split()
                hwl = ' '.join(str(float(x))[0:4] for x in line[8:11])
                ff.write(' '.join(line[0:8]) + ' ' + hwl + ' ' + ' '.join(line[11:]) + '\n')
    except FileNotFoundError:
        with open(path_new, 'a+'):
            pass


def strip_to_devkit_columns(path_src, path_dst):
    """Copy a KITTI detection txt keeping only the devkit's 16 columns.

    The C++ benchmark fscanf's exactly 16 fields per row
    (kitti-eval/evaluate_object.cpp:141-148), so monoloco's trailing bi/epi
    columns would desync the parse after the first detection. Writes an empty
    file if the source is missing or empty."""
    rows = []
    if os.path.exists(path_src):
        with open(path_src) as f:
            rows = [' '.join(line.split()[:16]) for line in f if line.split()]
    with open(path_dst, 'w') as f:
        f.write('\n'.join(rows) + ('\n' if rows else ''))


def find_cluster(dd, clusters):
    """Distance-bin lookup over increasing integer cluster edges."""
    for idx, clst in enumerate(clusters[:-1]):
        if int(clst) < dd <= int(clusters[idx + 1]):
            return clst
    return 'excluded'
