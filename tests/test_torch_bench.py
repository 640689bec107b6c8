"""The port's serving bench and kernel-ablation tool against the JAX
package's serving composition (bench.py:117-143), at batch 256.

Each bench leg and each ablation variant runs one serving pass on the CPU
(K^-1 normalize -> MLP -> decode), where the kernels' plain versions stand
in for them; the JAX side composes `preprocess_monoloco` -> its MLP (the
Pallas kernels in interpret mode) -> `extract_outputs` on the same folded
weights (hidden 128, 3 stages, the JAX fold as numpy) and the bench's own
keypoints. Tolerances on the decoded outputs (xyzd, bi, yaw, h, w, l):
 - f32: rtol/atol 1e-4 (two f32 frameworks; decode's exp and atan2 grow
   the MLP's 1e-6);
 - every bf16 or int8 leg: mean |diff| <= 1e-3 of the mean |output| and max
   <= 5e-2 (bf16 roundings and int8 rounding ties flip where the two
   frameworks' f32 sums differ in the last ulp; a wrong path misses by
   orders of magnitude).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import fold_eval_params as jax_fold
from monoloco_tpu.models import folded_forward as jax_folded_forward
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.network.decode import extract_outputs as jax_extract
from monoloco_tpu.network.preprocess import preprocess_monoloco as jax_preprocess
from monoloco_tpu.ops import fused_mlp as jf
from monoloco_tpu.ops import quant as jq
from monoloco_tpu_torch import bench, ops
from monoloco_tpu_torch.tools import bench_pallas_crossover, bench_pallas_int8

BATCH = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def folded():
    params, bn = jax_init(jax.random.PRNGKey(0), 34, 9, 128, 3)
    rng = np.random.default_rng(0)
    bn = jax.tree_util.tree_map(np.array, bn)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = rng.normal(0, 0.1, s['mean'].shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, s['var'].shape).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax_fold(params, bn))


@pytest.fixture(scope='module')
def torch_folded(folded):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), folded)


@pytest.fixture(scope='module')
def inputs():
    keypoints, kk = bench.bench_keypoints(BATCH, 'cpu')
    return keypoints, kk


def _jax_mlp(folded, leg):
    """The JAX package's MLP of one bench leg or ablation variant."""
    calib = jq.synthetic_calibration_inputs(34, n=4096)
    if leg in ('bf16', 'xla-bf16'):
        w = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), folded)
        return lambda x: jax_folded_forward(w, x.astype(jnp.bfloat16)).astype(jnp.float32)
    if leg == 'f32':
        return lambda x: jax_folded_forward(folded, x)
    if leg in ('int8-xla', 'xla-int8'):
        q = jq.quantize_folded(folded, calib)
        return lambda x: jq.quantized_forward(q, x)
    if leg in ('int8-a8', 'pallas-int8'):
        p = jf.pack_folded_weights_int8(folded, calib)
        return lambda x: jf.fused_loco_forward_int8(p, x, tile=128, interpret=True)
    if leg in ('int8', 'pallas-dyn8'):
        p = jf.pack_folded_weights_w8(folded)
        return lambda x: jf.fused_loco_forward_dyn8_auto(p, x, tile=128, interpret=True)
    if leg == 'pallas-w8':
        p = jf.pack_folded_weights_w8(folded)
        return lambda x: jf.fused_loco_forward_w8(p, x, tile=128, interpret=True)
    if leg in ('pallas-bf16', 'pallas-f32'):
        p = jf.pack_folded_weights(folded, jnp.bfloat16 if leg == 'pallas-bf16' else jnp.float32)
        return lambda x: jf.fused_loco_forward(None, x, packed=p, tile=128, interpret=True)
    raise ValueError(leg)


def _jax_serve(folded, leg, keypoints, kk):
    out = jax_extract(_jax_mlp(folded, leg)(jax_preprocess(jnp.asarray(keypoints.numpy()),
                                                          jnp.asarray(kk.numpy()))))
    return [np.asarray(v) for v in (out['xyzd'], out['bi'], out['yaw'][0], out['h'],
                                    out['w'], out['l'])]


def _assert_serving_close(ours, ref, leg):
    for i, (a, b) in enumerate(zip(ours, ref)):
        a = a.numpy()
        assert a.shape == b.shape == (BATCH, a.shape[1]), (leg, i)
        assert np.isfinite(a).all(), (leg, i)
        if leg in ('f32', 'pallas-f32'):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=f'{leg} output {i}')
        else:
            diff = np.abs(a - b)
            assert diff.mean() <= 1e-3 * np.abs(b).mean(), (leg, i, diff.mean())
            assert diff.max() <= 5e-2, (leg, i, diff.max())


@pytest.mark.parametrize('leg', ['bf16', 'f32', 'int8', 'int8-a8', 'int8-xla'])
def test_bench_leg_matches_jax_serving(torch_folded, folded, inputs, leg):
    keypoints, kk = inputs
    weights, mlp = bench.build_mlp(torch_folded, leg)
    ours = bench.serve_once(mlp, weights, keypoints, kk)
    _assert_serving_close(ours, _jax_serve(folded, leg, keypoints, kk), leg)


@pytest.mark.parametrize('variant', bench_pallas_int8.VARIANTS + bench_pallas_int8.EXTRA_VARIANTS)
def test_ablation_variant_matches_jax_serving(torch_folded, folded, inputs, variant):
    keypoints, kk = inputs
    mlp = bench_pallas_int8.build_mlps(torch_folded)[variant]
    ours = bench.serve_once(lambda _w, x: mlp(x), None, keypoints, kk)
    _assert_serving_close(ours, _jax_serve(folded, variant, keypoints, kk), variant)


def test_measure_runs_the_chained_program(torch_folded):
    """The timed program runs on the CPU at a toy size (a CPU time is no
    device metric; only the control flow and the checksum are checked)."""
    rate, checksum, ran = bench.measure(torch_folded, 'int8', batch=64, scan_iters=3,
                                        device='cpu')
    assert rate > 0 and np.isfinite(checksum)
    assert ran == {}                       # CPU tensors run the plain version
    rate2, checksum2, _ = bench.measure(torch_folded, 'int8', batch=64, scan_iters=3,
                                        device='cpu')
    assert checksum2 == checksum


def test_variant_record_has_the_jax_tools_keys(torch_folded):
    keypoints, kk = bench.bench_keypoints(32, 'cpu')
    mlp = bench_pallas_int8.build_mlps(torch_folded)['pallas-w8']
    rec = bench_pallas_int8.measure_variant('pallas-w8', mlp, keypoints, kk, 2)
    assert {'variant', 'inferences_per_sec', 'median_s', 'compile_s', 'batch', 'scan_iters',
            'tile'} <= set(rec)
    assert rec['batch'] == 32 and rec['launches'] == {} and np.isfinite(rec['checksum'])
    json.dumps(rec)


def test_bench_spellings_are_the_jax_benchs():
    assert bench._KNOWN_PRECISIONS == {'bf16', 'f32', 'int8', 'int8-a8', 'int8-xla',
                                       'float32', 'fp32', 'highest', 'bfloat16',
                                       'tensorfloat32', 'default'}
    assert bench.BATCH == 131072 and bench.SCAN_ITERS == 16
    assert bench_pallas_int8.VARIANTS == ('xla-bf16', 'xla-int8', 'pallas-bf16',
                                          'pallas-w8', 'pallas-dyn8', 'pallas-int8')


@pytest.mark.parametrize('precision,dtype', [('default', torch.bfloat16),
                                             ('bfloat16', torch.bfloat16),
                                             ('fp32', torch.float32),
                                             ('highest', torch.float32),
                                             ('tensorfloat32', torch.float32)])
def test_weight_storage_rule(torch_folded, precision, dtype):
    weights, _ = bench.build_mlp(torch_folded, precision)
    assert weights['l0']['w'].dtype == dtype
    assert weights['stages']['a']['w'].dtype == dtype


def test_bench_exits_on_an_unknown_precision(monkeypatch, capsys):
    monkeypatch.setenv('MONOLOCO_TPU_PRECISION', 'int8-dyn')
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert 'int8-dyn' in str(exc.value.code)
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('entry', ['bench', 'bench_pallas_int8', 'bench_pallas_crossover'])
def test_measuring_entries_refuse_without_cuda(monkeypatch, entry):
    """A measurement never falls back to the CPU."""
    monkeypatch.delenv('MONOLOCO_TPU_PRECISION', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = {'bench': bench.main, 'bench_pallas_int8': bench_pallas_int8.main,
            'bench_pallas_crossover': bench_pallas_crossover.main}[entry]
    with pytest.raises(RuntimeError, match='CUDA'):
        main([])


def test_launch_counters_cover_every_kernel():
    assert set(ops.launches) == {'dyn8_mlp', 'int8_static_mlp', 'w8_mlp',
                                 'fused_mlp_bf16', 'fused_mlp_f32',
                                 'wgmma_layer_bf16', 'wgmma_layer_w8',
                                 'wgmma_layer_f32', 'wgmma_layer_dyn8',
                                 'wgmma_layer_static', 'relu_chain_bf16'}
    assert sys.modules['monoloco_tpu_torch.ops'].launches is ops.launches
