"""The flat mono dispatch of `Loco.forward_batch_async` on the CPU.

Without a mesh a mono batch runs one MLP row a real detection, image by
image, rounded up to the 128-row tile (`engine._flat_rows`) but no more
than its padded (B, m) grid, for the plain pass and the MC-dropout passes
alike. Checked, on frames with and without detections, one image, a frame
that fills its bucket, 128 and 129 detections, and crowded frames whose
grid holds several tiles, for MonoLoco++ and the monoloco_p net: every
detection's outputs and epi equal the padded (B, m) grid's
(tests/torch_mono_grid.py) up to float order; the MC draws are the
bucket's; `rows_run` counts the flat rows; the outputs go to the host as
the flat rows, not the padded grid.
"""

import numpy as np
import pytest
import torch

import torch_mono_grid as grid
from monoloco_tpu_torch.models import init_loco_params
from monoloco_tpu_torch.network import Loco, engine
from monoloco_tpu_torch.utils import trace

N_DROPOUT, HIDDEN = 3, 64
# f32 throughout; only the order of the sums may differ from the grid's.
RTOL, EPI_RTOL = 1e-5, 1e-4
NETS = ('monoloco_pp', 'monoloco_p')


def _net(net='monoloco_pp', n_dropout=N_DROPOUT):
    params, bn = init_loco_params(2, 34, 9, HIDDEN, 2)
    # People 15 m ahead (theta = psi = pi/2): z = sqrt(d^2 - x^2 - y^2) is
    # well conditioned.
    params['w_fin']['b'][0:3] += torch.tensor([np.pi / 2, np.pi / 2, 15.0])
    return Loco((params, bn), mode='mono', net=net, device='cpu', n_dropout=n_dropout)


@pytest.fixture(scope='module')
def nets():
    return {(net, n): _net(net, n) for net in NETS for n in (0, N_DROPOUT)}


@pytest.fixture
def mc_net(nets):
    return nets['monoloco_pp', N_DROPOUT]


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.mark.parametrize('n_dropout', [0, N_DROPOUT])
@pytest.mark.parametrize('kind', NETS)
@pytest.mark.parametrize('mix', list(grid.MIXES))
def test_flat_dispatch_is_the_padded_grid_per_detection(nets, mix, kind, n_dropout):
    net = nets[kind, n_dropout]
    kps, kks = grid.frames(grid.MIXES[mix], seed=len(mix))
    outs = net.forward_batch(kps, kks)
    grid.assert_close(outs, grid.padded_grid(net, kps, kks), RTOL, EPI_RTOL)
    if n_dropout:
        masks, u = net.mc_last
        m_bucket = engine._bucket(max(max(grid.MIXES[mix]), 1))
        assert masks[0].shape == (N_DROPOUT, m_bucket, HIDDEN)
        assert u.shape == (engine.N_SAMPLES, m_bucket)


@pytest.mark.parametrize('mix', list(grid.MIXES))
def test_rows_run_counts_the_flat_rows(mc_net, mix):
    counts = grid.MIXES[mix]
    trace.enable()
    mc_net.forward_batch(*grid.frames(counts))
    trace.disable()
    (dispatch,) = [r for r in trace.records() if r['name'] == 'loco.dispatch']
    passes = 1 + N_DROPOUT
    assert dispatch['attrs']['rows_run'] == grid.ROWS[mix] * passes
    assert dispatch['attrs']['rows_useful'] == sum(counts) * passes
    assert grid.rows(counts) == grid.ROWS[mix]


@pytest.mark.parametrize('mix', ['empty_frames', 'tile_plus_one', 'crowded_frame'])
def test_staged_outputs_leave_as_the_flat_rows(mc_net, monkeypatch, mix):
    """Every output leaf goes to the host (ordinary memory on the CPU) with
    one row a flat row, epi too."""
    made = []

    class Recorded(engine._HostCopy):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(engine, '_HostCopy', Recorded)
    mc_net.forward_batch(*grid.frames(grid.MIXES[mix]))
    (out,) = made
    rows = grid.ROWS[mix]
    assert {shape[0] for *_, shape in out.leaves} == {rows}
    assert [shape for key, *_, shape in out.leaves if key == 'epi'] == [(rows,)]

