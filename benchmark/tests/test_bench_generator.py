"""The frozen pose generator and the pools drawn from a seed."""

import numpy as np

from benchmark import manifest
from benchmark.generators import crowd_frames as cf


def test_people_keypoints_is_make_person():
    for seed in (0, 7):
        rng = np.random.RandomState(seed)
        x, z = 1.3, 12.5
        flat, _, _ = cf.make_person(x, z, rng, cam_shift=cf.BASELINE)
        rng = np.random.RandomState(seed)
        noise = np.array([rng.randn() for _ in range(34)]).reshape(1, 17, 2)
        rand = np.array([rng.rand() for _ in range(17)]).reshape(1, 17)
        kk = np.array([[[cf.FX, 0, cf.CX], [0, cf.FY, cf.CY], [0, 0, 1]]])
        kps = cf.people_keypoints(np.array([x]), np.array([z]), noise, rand, kk,
                                  cam_shift=cf.BASELINE)[0]
        want = np.asarray(flat, np.float32).reshape(17, 3).T
        np.testing.assert_allclose(kps, want, atol=0.011)


def _traffic(name, **kw):
    return dict(manifest.resolve(name)['traffic'], **kw)


def test_pool_is_the_same_work_for_every_seed():
    traffic = _traffic('monstereo-crowd-int8', pool_chunks=6)
    pools = [cf.make_pool(traffic, seed) for seed in (1, 2 ** 31 + 12345)]

    def work(pool):
        return sorted((tuple(sorted(c['counts'])), tuple(sorted(c['counts_r']))) for c in pool)

    assert work(pools[0]) == work(pools[1])
    for pool in pools:
        for chunk in pool:
            assert len(chunk['left']) == traffic['chunk_frames']
            assert min(chunk['counts']) >= 1 and min(chunk['counts_r']) >= 1
            for kps, m in zip(chunk['left'], chunk['counts']):
                assert kps.shape == (m, 3, 17) and kps.dtype == np.float32
            for kps, r in zip(chunk['right'], chunk['counts_r']):
                assert kps.shape == (r, 3, 17)
    # The seed changes the order and the people, not the work.
    assert [c['counts'] for c in pools[0]] != [c['counts'] for c in pools[1]]
    again = cf.make_pool(traffic, 1)
    np.testing.assert_array_equal(again[2]['left'][5], pools[0][2]['left'][5])


def test_counts_follow_the_mix():
    """People a frame: Poisson with the mix's mean; the right view loses and
    gains the baseline strip's share; the chunks' largest frames, and so
    the engine's buckets, differ from chunk to chunk."""
    traffic = _traffic('monstereo-crowd-int8')
    left, right, kept = cf.chunk_sizes(traffic)
    assert left.shape == (traffic['pool_chunks'], traffic['chunk_frames'])
    assert abs(left.mean() - traffic['people_mean']) < 0.3
    assert abs(left.var() / left.mean() - 1.0) < 0.15
    p = cf.edge_share(traffic)
    assert 0.01 < p < 0.03
    assert abs((left - kept).sum() / left.sum() - p) < 0.006
    assert np.all(kept <= left) and np.all(right >= 1)
    buckets = {int(2 ** np.ceil(np.log2(m))) for m in left.max(axis=1)}
    assert len(buckets) >= 2
    mono = _traffic('monoloco_pp-mc10-f32')
    np.testing.assert_array_equal(cf.chunk_sizes(mono)[0], left)


def test_right_view_is_shifted_left_by_the_disparity():
    """A person of both views keeps its image rows (v) and moves left by f B
    / z, and f / z is what its height in pixels says: each right pose is
    matched to the left pose of its frame with the nearest rows."""
    traffic = _traffic('monstereo-crowd-int8', pool_chunks=1)
    chunk = cf.make_pool(traffic, 3)[0]
    off = []
    for left, right in zip(chunk['left'], chunk['right']):
        for pose in right:
            i = np.argmin(np.abs(left[:, 1] - pose[1]).sum(axis=1))
            disparity = np.mean(left[i, 0] - pose[0])
            f_over_z = (pose[1, 15] - pose[1, 0]) / (1.65 - 0.07)
            off.append(disparity - traffic['baseline'] * f_over_z)
    assert np.median(np.abs(off)) < 1.0
