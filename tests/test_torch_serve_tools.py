"""The port's serving tools (monoloco_tpu_torch/tools/bench_serve.py,
bench_latency.py, bench_int8_crossover.py) against the JAX package's
`tools/` counterparts, on the CPU at a toy size.

A CPU time is no device metric: these tests check the control flow, the
JSON records' keys, the statistics helpers and the crossover rule against
the JAX tools', the serving programs' outputs against each other (the dyn8
plain version against the f32 MLP within the dyn8 budget, 0.02 mean
relative on the decoded distance) and that every measuring entry refuses
to run without a card.
"""

import argparse
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.network import Loco as JaxLoco
from monoloco_tpu.serve import Batcher as JaxBatcher
from monoloco_tpu_torch import bench
from monoloco_tpu_torch.models import init_loco_params
from monoloco_tpu_torch.network import Loco
from monoloco_tpu_torch.serve import Batcher
from monoloco_tpu_torch.tools import bench_int8_crossover, bench_latency, bench_serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A module of the JAX package's tools/ directory (no package there)."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tools_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def folded():
    return bench.bench_folded(hidden=128, device='cpu')


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith('{')]


def test_direct_sweep_prints_the_jax_keys(capsys):
    """run_direct_sweep over a CPU net (--duration 0.2) prints the JAX
    tool's records, key for key, beside the JAX tool's own run."""
    args = argparse.Namespace(dets=4, window_ms=2.0, max_batch=8, max_queue=None,
                              sweep='50,200', duration=0.2)
    net = Loco(init_loco_params(0, 34, 9, 64, 2), mode='mono', device='cpu')
    records = bench_serve.run_direct_sweep(args, net, Batcher)
    ours = _json_lines(capsys.readouterr().out)
    params, bn = jax_init(jax.random.PRNGKey(0), 34, 9, 64, 2)
    _jax_tool('bench_serve').run_direct_sweep(args, JaxLoco((params, bn), mode='mono'),
                                              JaxBatcher)
    ref = _json_lines(capsys.readouterr().out)
    assert ours == records and len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
    assert ours[0]['offered_rps'] == 50.0 and ours[0]['ok'] + ours[0]['shed'] == ours[0]['fired']
    assert ours[-1]['dispatches'] > 0 and ours[-1]['int8_kernel_packed'] is False


def test_warm_batch_buckets_dispatches_the_jax_tools_shapes():
    class _Counting:
        def __init__(self):
            self.calls = []

        def forward_batch(self, kps, kks):
            self.calls.append((len(kps), kps[0].shape))

    for max_batch in (1, 6, 8, 64):
        ours, ref = _Counting(), _Counting()
        bench_serve.warm_batch_buckets(ours, max_batch, 3)
        _jax_tool('bench_serve').warm_batch_buckets(ref, max_batch, 3)
        assert ours.calls == ref.calls and ours.calls[-1][0] == max_batch


def test_bench_serve_flags_are_the_jax_tools():
    import re
    with open(os.path.join(REPO, 'tools', 'bench_serve.py')) as f:
        jax_flags = set(re.findall(r"add_argument\('(--[\w-]+)'", f.read()))
    ours = {a for action in bench_serve._parser()._actions for a in action.option_strings}
    assert jax_flags == ours - {'-h', '--help'}
    args = bench_serve._parser().parse_args([])
    assert (args.clients, args.requests, args.dets, args.window_ms, args.max_batch,
            args.duration) == (32, 20, 4, 2.0, 64, 10.0)


@pytest.mark.parametrize('n', [1, 2, 7, 200])
def test_percentiles_are_the_jax_tools(n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    assert bench_latency.percentiles(xs) == _jax_tool('bench_latency').percentiles(xs)


def test_latency_records_on_the_cpu(folded, capsys):
    records = bench_latency.measure(folded, [1, 16], reps=3, warmup=1, device='cpu')
    assert _json_lines(capsys.readouterr().out) == records
    floor, rest = records[0], records[1:]
    assert floor['metric'] == 'dispatch_floor_ms' and floor['device'] == 'cpu'
    assert {'p50', 'p90', 'p99', 'min', 'max'} <= set(floor)
    assert [(r['precision'], r['batch']) for r in rest] == [
        (p, b) for b in (1, 16) for p in bench_latency.PRECISIONS]
    for rec in rest:
        assert {'metric', 'batch', 'p50', 'p90', 'p99', 'min', 'max', 'p50_minus_floor_ms',
                'inferences_per_sec_at_p50'} <= set(rec)
        assert np.isfinite(rec['checksum']) and rec['launches'] == {}


def test_latency_checksums_agree_across_precisions(folded):
    """The three legs compute one function: their checksums over 256 rows
    agree within the int8 and bf16 budgets."""
    keypoints, kk = bench.bench_keypoints(256, 'cpu')
    with torch.inference_mode():
        sums = {name: bench_latency.serve_checksum(mlp, keypoints, kk)
                for name, mlp in bench_latency.build_mlps(folded).items()}
    for name in ('bf16', 'int8'):
        assert abs(sums[name] - sums['default']) <= 0.02 * abs(sums['default']), sums
    with pytest.raises(ValueError, match='unknown precision'):
        bench_latency.build_mlps(folded, ('int4',))


def test_crossover_record_on_cpu_plain_versions(folded):
    paths = bench_int8_crossover.build_paths(folded)
    rec = bench_int8_crossover.measure_rows(paths, 64, reps=2, scan_iters=2, device='cpu')
    assert {'rows', 'dyn8_inf_per_s', 'f32_inf_per_s', 'bf16_inf_per_s', 'dyn8_over_f32',
            'bf16_over_f32', 'per_call_ms', 'rel_dd_vs_f32', 'checksum', 'launches'} <= set(rec)
    assert rec['rows'] == 64 and set(rec['per_call_ms']) == set(bench_int8_crossover.PATHS)
    assert rec['rel_dd_vs_f32']['mean'] < 0.02
    assert all(np.isfinite(v) for v in rec['checksum'].values())
    assert rec['launches'] == {'dyn8': {}, 'f32': {}, 'bf16': {}}
    json.dumps(rec)


def _jax_crossover(ratios, rows):
    """The JAX tool's rule (tools/bench_int8_crossover.py:165-171) on
    (rows, dyn8/bf16) records."""
    records = [{'rows': n, 'dyn8_over_bf16': r} for n, r in zip(rows, ratios)]
    for i, rec in enumerate(records):
        if all(r['dyn8_over_bf16'] > 1.0 for r in records[i:]):
            return rec['rows']
    return None


@pytest.mark.parametrize('ratios', [(0.5, 0.9, 1.1, 1.3), (1.2, 0.9, 1.1, 1.3),
                                    (0.5, 0.6, 0.9, 0.8), (1.1, 1.2, 1.5, 3.0),
                                    (0.5, 1.2, 0.99, 1.01), (0.5, 0.9, 1.0, 1.2)])
def test_crossover_rule_is_the_jax_tools(ratios):
    rows = (128, 512, 2048, 131072)
    records = [{'rows': n, 'dyn8_over_f32': r} for n, r in zip(rows, ratios)]
    assert bench_int8_crossover.crossover(records[::-1]) == _jax_crossover(ratios, rows)


@pytest.mark.parametrize('tool', ['bench_serve', 'bench_latency', 'bench_int8_crossover'])
def test_tools_refuse_without_cuda(monkeypatch, capsys, tool):
    """A measurement never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = {'bench_serve': bench_serve.main, 'bench_latency': bench_latency.main,
            'bench_int8_crossover': bench_int8_crossover.main}[tool]
    with pytest.raises(RuntimeError, match='CUDA'):
        main([])
    assert capsys.readouterr().out == ''


def test_chained_call_is_the_benchs_timed_program(folded):
    """bench.time_serving times bench.chained_call: the same checksum."""
    keypoints, kk = bench.bench_keypoints(32, 'cpu')
    weights, mlp = bench.build_mlp(folded, 'f32')

    def serve(kps, k):
        return bench.serve_once(mlp, weights, kps, k)

    with torch.inference_mode():
        direct = bench.chained_call(serve, keypoints, kk, 3)
    _, checksum, _ = bench.time_serving(serve, keypoints, kk, 3, reps=1)
    assert checksum == direct and np.isfinite(direct)
