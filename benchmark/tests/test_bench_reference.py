"""The plain reference against the program on the CPU at hidden 32 and 128:
the check's numbers of a sound program are rounding-sized."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, manifest
from benchmark.tests.bench_helpers import shrink


def _spec(workload, hidden, **traffic):
    return shrink(manifest.resolve(workload), hidden, **traffic)


def _numbers(spec, precision, ref_mode='f32', seed=3):
    spec['traffic']['precision'] = precision
    harness.set_environment(spec['traffic'])
    dev = torch.device('cpu')
    pool, weights = harness.prepare(spec, seed, dev)
    engine = harness.build_engine(spec, weights, dev)
    numbers = check.Numbers('counts_r' in pool[0], spec['traffic'].get('n_dropout', 0) > 0)
    for chunk in pool:
        args = [chunk['left'], chunk['kk']] + ([chunk['right']] if 'right' in chunk else [])
        outs = engine.forward_batch(*args)
        check.compare_chunk(spec['config'], spec['traffic'], weights, chunk, outs, dev, numbers,
                            ref_mode)
    assert numbers.detections == sum(sum(c['counts']) for c in pool)
    return numbers.values


@pytest.mark.parametrize('hidden', [32, 128])
def test_stereo_f32(hidden):
    v = _numbers(_spec('monstereo-crowd-int8', hidden), 'default')
    assert v['rows_missing'] == 0 and v['raw_err'] < 1e-3 and v['aux_gap'] < 1e-4


@pytest.mark.parametrize('hidden', [32, 128])
def test_mono_mc_f32(hidden):
    v = _numbers(_spec('monoloco_pp-mc10-f32', hidden, n_dropout=3), 'default')
    assert v['rows_missing'] == 0 and v['raw_err'] < 1e-3 and v['epi_err'] < 1e-3


def test_stereo_bf16_against_the_stated_arithmetic():
    # hidden 128 takes the K1-bf16 route (its plain version on the CPU).
    v = _numbers(_spec('monstereo-crowd-bf16', 128), 'bf16', ref_mode='bf16')
    assert v['rows_missing'] == 0 and v['raw_err'] < 0.05


def test_reference_outputs_in_the_programs_place_read_zero():
    spec = _spec('monoloco_pp-mc10-f32', 32, n_dropout=2)
    harness.set_environment(spec['traffic'])
    dev = torch.device('cpu')
    pool, weights = harness.prepare(spec, 4, dev)
    numbers = check.Numbers(False, True)
    for chunk in pool:
        outs = check.reference_outputs(spec['config'], spec['traffic'], weights, chunk, dev, 'f32')
        check.compare_chunk(spec['config'], spec['traffic'], weights, chunk, outs, dev, numbers)
    assert numbers.values['raw_err'] < 1e-4 and numbers.values['epi_err'] == 0.0
    assert np.isfinite(numbers.values['raw_err'])
