"""The port's activity rules (`monoloco_tpu_torch/activity.py`, the engine's
`social_distance` and `raising_hand`) against the JAX package's on fuzzed
inputs from numpy seeds: every boolean and every raised-hand label equal,
and each resampled scene of the port's stacked F-formation test flagged as
the JAX package's per-scene call flags it.
Model: tests/test_reference_parity_activity.py:64-120."""

import argparse
import math

import numpy as np
import pytest

from monoloco_tpu import activity as jax_activity
from monoloco_tpu.geometry.host import np_laplace_sampling as jax_np_laplace_sampling
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu_torch import activity
from monoloco_tpu_torch.geometry.host import np_laplace_sampling
from monoloco_tpu_torch.network import Loco


def _scene(rng, spread=4.0):
    n = int(rng.integers(2, 6))
    centers = [[float(rng.uniform(-spread, spread)), float(rng.uniform(2, 10))]
               for _ in range(n)]
    angles = [float(rng.uniform(-math.pi, math.pi)) for _ in range(n)]
    return centers, angles


@pytest.mark.parametrize('social_distance', [False, True])
def test_check_f_formations_fuzz(social_distance):
    rng = np.random.default_rng(0)
    positives = 0
    for _ in range(300):
        centers, angles = _scene(rng)
        ours = activity.check_f_formations(0, 1, centers, angles, radii=(0.3, 0.5, 1.0),
                                           social_distance=social_distance)
        theirs = jax_activity.check_f_formations(0, 1, centers, angles, radii=(0.3, 0.5, 1.0),
                                                 social_distance=social_distance)
        assert bool(ours) == bool(theirs)
        positives += bool(ours)
    assert positives > 0


def test_social_interactions_deterministic_fuzz():
    rng = np.random.default_rng(1)
    positives = 0
    for _ in range(200):
        centers, angles = _scene(rng, spread=3.0)
        dds = [float(np.linalg.norm(c)) for c in centers]
        for sd in (False, True):
            kw = dict(n_samples=1, threshold_dist=2.5, radii=(0.3, 0.5, 1), social_distance=sd)
            ours = activity.social_interactions(0, centers, angles, dds, **kw)
            assert bool(ours) == bool(jax_activity.social_interactions(0, centers, angles,
                                                                       dds, **kw))
            positives += bool(ours)
    assert positives > 0


def test_social_interactions_probabilistic_fuzz():
    """The Laplace-resampled branch (100 samples, the sampler reseeded on
    every call) gives the same flag for every person."""
    rng = np.random.default_rng(2)
    positives = 0
    for _ in range(40):
        centers, angles = _scene(rng, spread=2.0)
        dds = [float(np.linalg.norm(c)) for c in centers]
        stds = [float(rng.uniform(0.1, 1.5)) for _ in centers]
        for idx in range(len(centers)):
            kw = dict(stds=stds, threshold_prob=0.25, threshold_dist=2.5, radii=(0.3, 0.5, 1))
            ours = activity.social_interactions(idx, centers, angles, dds, **kw)
            assert bool(ours) == bool(jax_activity.social_interactions(idx, centers, angles,
                                                                       dds, **kw))
            positives += bool(ours)
    assert positives > 0


@pytest.mark.parametrize('social_distance', [False, True])
def test_stacked_f_formations_are_the_jax_per_scene_flags(social_distance):
    """The port tests a pair's 100 resampled scenes in one stack; each
    scene's flag equals the JAX package's `check_f_formations` on it."""
    rng = np.random.default_rng(7)
    positives = 0
    for _ in range(30):
        centers, angles = _scene(rng, spread=2.0)
        stack = np.asarray(centers)[None] + rng.normal(0, 0.5, (100, len(centers), 2))
        ours = activity._f_formations(0, 1, stack, angles, (0.3, 0.5, 1), social_distance)
        theirs = [jax_activity.check_f_formations(0, 1, scene, angles, radii=(0.3, 0.5, 1),
                                                  social_distance=social_distance)
                  for scene in stack]
        assert ours.tolist() == [bool(t) for t in theirs]
        positives += int(ours.sum())
    assert 0 < positives < 3000


def test_np_laplace_sampling_is_the_jax_hosts():
    outputs = np.random.default_rng(3).uniform(1, 20, size=(6, 2))
    np.testing.assert_array_equal(np_laplace_sampling(outputs, 100),
                                  jax_np_laplace_sampling(outputs, 100))


def _kp(rng):
    kp = np.zeros((3, 17))
    kp[0] = rng.uniform(100, 200, 17)
    kp[1] = rng.uniform(100, 300, 17)
    kp[2] = 0.9
    # bias some cases toward risen arms (hands above shoulders)
    if rng.random() < 0.5:
        kp[1, 9] = kp[1, 5] - rng.uniform(5, 80)
    if rng.random() < 0.5:
        kp[1, 10] = kp[1, 6] - rng.uniform(5, 80)
    return kp


def test_is_raising_hand_fuzz():
    rng = np.random.default_rng(4)
    outcomes = set()
    for _ in range(400):
        kp = _kp(rng).tolist()
        ours = activity.is_raising_hand(kp)
        assert ours == jax_activity.is_raising_hand(kp)
        outcomes.add(ours)
    assert {'left', 'right', 'both', None} <= outcomes
    collapsed = np.zeros((3, 17)).tolist()          # hand == elbow == shoulder
    assert activity.is_raising_hand(collapsed) is None


def _dic_out(rng, n):
    xyz = [[float(rng.uniform(-2, 2)), 0.5, float(rng.uniform(3, 8))] for _ in range(n)]
    return {'xyz_pred': xyz, 'angles': [float(rng.uniform(-math.pi, math.pi)) for _ in range(n)],
            'dds_pred': [float(np.linalg.norm(p)) for p in xyz],
            'stds_ale': [float(rng.uniform(0.1, 1.0)) for _ in range(n)]}


def test_engine_social_distance_matches_jax():
    args = argparse.Namespace(threshold_prob=0.25, threshold_dist=2.5, radii=(0.3, 0.5, 1))
    rng = np.random.default_rng(5)
    flags = []
    for _ in range(20):
        dic = _dic_out(rng, int(rng.integers(2, 7)))
        ours = Loco.social_distance(dict(dic), args)['social_distance']
        assert ours == JaxLoco.social_distance(dict(dic), args)['social_distance']
        assert all(isinstance(f, bool) for f in ours)
        flags += ours
    assert any(flags) and not all(flags)


def test_engine_raising_hand_matches_jax():
    rng = np.random.default_rng(6)
    keypoints = [_kp(rng).tolist() for _ in range(30)]
    ours = Loco.raising_hand({}, keypoints)['raising_hand']
    assert ours == JaxLoco.raising_hand({}, keypoints)['raising_hand']
    assert len(set(ours)) > 1
