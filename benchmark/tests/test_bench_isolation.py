"""The benchmark's yardstick imports nothing of the program, and nothing a
run loads is JAX, Flax or the JAX package (top-level names compared whole:
`monoloco_tpu_torch` begins with `monoloco_tpu`)."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import manifest

ROOT = str(manifest.ROOT)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'monoloco_tpu')


def _python(code):
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_yardstick_imports_nothing_of_the_program():
    out = _python(
        'import sys; sys.path.insert(0, "."); '
        'import benchmark.reference.loco_mlp, benchmark.flops, '
        'benchmark.check, benchmark.manifest, benchmark.trace, benchmark.readings, '
        'benchmark.generators.crowd_frames, benchmark.loops.bulk_chunks; '
        'print(sorted({m.split(".")[0] for m in sys.modules}))')
    tops = set(eval(out))
    assert not tops & {'monoloco_tpu_torch', *FORBIDDEN}


def test_a_run_loads_no_jax():
    code = (
        'import sys, json, time; sys.path.insert(0, "."); t = time.perf_counter()\n'
        'from benchmark import harness, manifest\n'
        'from benchmark.tests.bench_helpers import shrink\n'
        'spec = shrink(manifest.resolve("monoloco_pp-mc10-f32"), 32, chunk_frames=4, '
        'people_mean=2.0, warmup_chunks=1, check_chunks=2, n_dropout=2)\n'
        'res = harness.run("monoloco_pp-mc10-f32", 5, 0.2, True, t, spec=spec, device="cpu")\n'
        'print(json.dumps({"forbidden": harness.forbidden_modules(), '
        '"tops": sorted({m.split(".")[0] for m in sys.modules}), "correct": res["correct"]}))')
    out = json.loads(_python(code).strip().splitlines()[-1])
    assert out['forbidden'] == []
    assert not set(out['tops']) & set(FORBIDDEN)
    assert 'monoloco_tpu_torch' in out['tops'] and out['correct']


def test_no_card_no_result():
    res = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'monstereo-crowd-int8', '--seed', '3000000000', '--seconds', '1',
                          '--trace', '0'], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert res.returncode != 0
    assert res.stdout.strip() == ''


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The look for JAX comes last, after every metric's reader has been
    loaded and run: a reader that imports a module named `jax` makes the run
    exit 3 with nothing on stdout. In a copy of the benchmark, whose
    `setup_s` reader imports a stand-in `jax` from the copy's root; the run
    is `run.py`'s own `main`, on the CPU at a small size."""
    root = tmp_path / 'checkout'
    shutil.copytree(manifest.BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(manifest.ROOT / 'BENCHMARK.json', root)
    (root / 'jax.py').write_text('LOADED = True\n')
    reader = root / 'benchmark' / 'metrics' / 'setup_s.py'
    reader.write_text('import jax  # noqa: F401\n\n' + reader.read_text())
    code = (
        'import sys, torch; sys.path.insert(0, ".")\n'
        'from benchmark import harness, manifest, run\n'
        'from benchmark.tests.bench_helpers import shrink\n'
        'spec = shrink(manifest.resolve("monoloco_pp-mc10-f32"), 32, chunk_frames=4, '
        'people_mean=2.0, warmup_chunks=1, check_chunks=2, n_dropout=2)\n'
        'manifest.resolve = lambda workload, root=None: spec\n'
        'harness._device = lambda chips: torch.device("cpu")\n'
        'sys.exit(run.main(["--workload", "monoloco_pp-mc10-f32", "--seed", "9", '
        '"--seconds", "0.2", "--trace", "0"]))\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=root, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 3, res.stderr[-3000:]
    assert res.stdout == ''
    assert "['jax']" in res.stderr
