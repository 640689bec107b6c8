"""Mono batches of tests/test_torch_mono_flat.py and
tests/test_torch_staged_cuda.py, and the padded-grid evaluation that the
engine's flat mono dispatch is held to. Imports torch and the port only (no
jax), so the card's tests can use it.

`padded_grid` is the engine's mono dispatch (MonoLoco++ or the
monoloco_p net) before its detections went flat: every image padded to the
batch's detection bucket, all B x m cells through the folded f32 MLP, and
the MC-dropout passes over the (B, m) grid with the bucket's keep-masks and
uniforms (`Loco.draw_mc`) alike for every image.
"""

import numpy as np
import torch

from monoloco_tpu_torch.models import folded_forward, folded_forward_mc
from monoloco_tpu_torch.network import (engine, extract_outputs, extract_outputs_mono,
                                        laplace_sampling, preprocess_monoloco, unnormalize_bi)
from torch_stereo_grid import KK, KK2, keypoints

# Detections a frame.
MIXES = {
    'empty_frames': (3, 0, 5, 0),
    'all_empty': (0, 0, 0),
    'one_image': (7,),
    'full_bucket': (8, 3),                    # frame 0 fills its bucket of 8
    'one_tile': (32, 32, 32, 32),             # 128 detections: one 128-row tile
    'tile_plus_one': (32, 32, 32, 33),        # 129: two tiles
    'crowded_frame': (40, 2, 0, 3, 1),        # 46 in one tile of an 8 x 64 grid
    'two_tiles': (70, 30, 29, 1),             # 130 in two tiles of a 4 x 128 grid
}
# The MLP rows of each mix's dispatch: its real detections rounded up to the
# 128-row tile, but no more than its padded (B, m) grid.
ROWS = {'empty_frames': 32, 'all_empty': 16, 'one_image': 8, 'full_bucket': 16,
        'one_tile': 128, 'tile_plus_one': 256, 'crowded_frame': 128, 'two_tiles': 256}


def rows(counts):
    """The MLP rows of a dispatch of frames with `counts` detections."""
    grid = engine._bucket(len(counts), minimum=1) * engine._bucket(max(max(counts), 1))
    return min(grid, engine._flat_rows(sum(counts)))


def frames(counts, seed=0):
    """(keypoints, kks) lists of one batch."""
    rng = np.random.default_rng(seed)
    return ([keypoints(n, rng) for n in counts],
            [KK if i % 2 == 0 else KK2 for i in range(len(counts))])


def padded_grid(net, kps_list, kks):
    """Per image (None without detections): the decoded outputs of its
    detections and, with MC dropout, their epistemic std, from the padded
    (B, m) grid on the engine's device."""
    counts = [len(k) for k in kps_list]
    b, m = len(counts), engine._bucket(max(max(counts), 1))
    kps = np.zeros((b, m, 3, 17), np.float32)
    for i, k in enumerate(kps_list):
        kps[i, :len(k)] = k
    dev = net.device
    with torch.inference_mode():
        x = preprocess_monoloco(torch.from_numpy(kps).to(dev),
                                torch.from_numpy(np.asarray(kks, np.float32)).to(dev))
        folded = net.mlp_weights['folded'].folded()
        decode = extract_outputs_mono if net.net == 'monoloco_p' else extract_outputs
        dic = decode(folded_forward(folded, x.reshape(b * m, -1), net.arch))
        epi = None
        if net.n_dropout:
            masks, u = net.draw_mc(m)
            out = folded_forward_mc(folded, x, [k[:, None] for k in masks], net.p_dropout,
                                    net.arch)
            db = out[..., 2:4]                                           # (n, B, m, 2)
            mu_b = torch.cat([db[..., 0:1], unnormalize_bi(db)], dim=-1)
            samples = laplace_sampling(mu_b, engine.N_SAMPLES, u=u)     # (n, B, S, m)
            epi = torch.std(samples.transpose(0, 1).reshape(b, -1, m), dim=1, correction=1)
    outs = []
    for i, n in enumerate(counts):
        if n == 0:
            outs.append(None)
            continue
        sl = slice(i * m, i * m + n)
        out = {k: (v[0][sl].cpu().numpy(), v[1][sl].cpu().numpy()) if k == 'yaw'
               else v[sl].cpu().numpy() for k, v in dic.items()}
        out['epi'] = None if epi is None else epi[i, :n].cpu().numpy()
        outs.append(out)
    return outs


def assert_close(outs, refs, rtol, epi_rtol):
    """Every detection's outputs within rtol (atol rtol too) of the padded
    grid's, and its epi within epi_rtol."""
    assert len(outs) == len(refs)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert (out is None) == (ref is None), i
        if ref is None:
            continue
        assert sorted(out) == sorted(ref), i
        for key, value in ref.items():
            if key == 'epi':
                if value is None:
                    assert list(out['epi']) == [0.] * len(ref['d'])
                else:
                    assert out['epi'].shape == value.shape and (out['epi'] > 0).all()
                    np.testing.assert_allclose(out['epi'], value, rtol=epi_rtol, atol=0,
                                               err_msg=f'{i} epi')
                continue
            for j, arr in enumerate(value if key == 'yaw' else (value,)):
                got = out[key][j] if key == 'yaw' else out[key]
                assert got.shape == arr.shape and got.dtype == arr.dtype, (i, key)
                np.testing.assert_allclose(got, arr, rtol=rtol, atol=rtol,
                                           err_msg=f'{i} {key} {j}')
