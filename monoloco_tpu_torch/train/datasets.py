"""Dataset loading: joints JSON -> numpy arrays. A copy of
`monoloco_tpu/train/datasets.py`.

The joints file schema is prep's: {train|val|test: {X, Y, names, kps, K,
clst: {bin: {X, Y, kps}}}, version}. A whole dataset is a few MB of float32;
the trainer copies it to the device once and runs every epoch from there.
"""

import json
import os

import numpy as np


def _load_joints_cached(joints):
    """Parse a joints JSON once, memoizing the parsed structure (numeric fields
    as numpy arrays) in a pickle sidecar.

    Full-KITTI joints files are >100 MB of JSON, and re-parsing one for every
    Trainer costs tens of seconds of host time. The sidecar (`<joints>.cache.pkl`,
    numpy arrays, lists and dicts only) is the JAX package's format, so
    either package reads a sidecar the other wrote. It is rewritten when the
    source's size or mtime changes.
    """
    import pickle
    sidecar = joints + '.cache.pkl'
    stat = os.stat(joints)
    source_id = (stat.st_size, stat.st_mtime_ns)
    if os.path.exists(sidecar):
        try:
            with open(sidecar, 'rb') as f:
                cached = pickle.load(f)
            # An exact size+mtime match: a file replaced by one with an older
            # mtime (cp -p, mv, git checkout) is caught, unlike with >=.
            if cached.get('_source_id') == source_id:
                return cached
        except Exception:
            pass
    with open(joints, 'r') as f:
        dic_jo = json.load(f)
    cached = {'version': dic_jo.get('version', 'unknown'),
              '_source_id': source_id}
    for phase in ('train', 'val', 'test'):
        if phase not in dic_jo:
            continue
        ph = dic_jo[phase]
        cached[phase] = {
            'X': np.asarray(ph.get('X', []), np.float32),
            'Y': np.asarray(ph.get('Y', []), np.float32),
            'kps': np.asarray(ph.get('kps', []), np.float32),
            'names': ph.get('names', []),
            'clst': ph.get('clst', {}),
        }
    try:
        with open(sidecar, 'wb') as f:
            pickle.dump(cached, f)
    except OSError:
        pass  # read-only location: skip caching
    return cached


class KeypointsDataset:
    """Eager array-backed dataset for the KITTI/nuScenes joints JSONs."""

    def __init__(self, joints, phase):
        assert phase in ('train', 'val', 'test')
        dic_jo = _load_joints_cached(joints)
        self.inputs_all = dic_jo[phase]['X']
        self.outputs_all = dic_jo[phase]['Y']
        self.kps_all = dic_jo[phase]['kps']
        self.names_all = dic_jo[phase]['names']
        self.version = dic_jo.get('version', 'unknown')
        self.dic_clst = dic_jo[phase]['clst']

    def __len__(self):
        return self.inputs_all.shape[0]

    def __getitem__(self, idx):
        return (self.inputs_all[idx], self.outputs_all[idx],
                self.names_all[idx] if isinstance(idx, int) else [self.names_all[i] for i in np.atleast_1d(np.arange(len(self))[idx])],
                self.kps_all[idx])

    def arrays(self):
        """Full (X, Y) numpy arrays, which the trainer moves to its device once."""
        return self.inputs_all, self.outputs_all

    def get_cluster_annotations(self, clst):
        if clst not in self.dic_clst:  # tiny datasets can have empty clusters
            return np.zeros((0,), np.float32), np.zeros((0,), np.float32), 0
        inputs = np.asarray(self.dic_clst[clst]['X'], dtype=np.float32)
        outputs = np.asarray(self.dic_clst[clst]['Y'], dtype=np.float32)
        return inputs, outputs, len(self.dic_clst[clst]['Y'])

    def get_version(self):
        return self.version


class ActivityDataset:
    """X/Y-only variant for the activity (social interaction) head."""

    def __init__(self, joints, phase):
        assert phase in ('train', 'val', 'test')
        with open(joints, 'r') as f:
            dic_jo = json.load(f)
        self.inputs_all = np.asarray(dic_jo[phase]['X'], dtype=np.float32)
        self.outputs_all = np.asarray(dic_jo[phase]['Y'], dtype=np.float32).reshape(-1, 1)

    def __len__(self):
        return self.inputs_all.shape[0]

    def __getitem__(self, idx):
        return self.inputs_all[idx], self.outputs_all[idx]

    def arrays(self):
        return self.inputs_all, self.outputs_all
