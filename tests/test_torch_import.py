"""The torch port never imports jax (nor optax, which the JAX package's
trainer checkpoints reference, nor orbax), and a json-only predict run and
the KITTI eval path, the ReID baseline (its images decoded, cropped and
resized by `utils/image.py`) and the device meshes import neither
matplotlib nor Pillow (the card's machine has no matplotlib and maybe no
Pillow); cv2 is imported only by the webcam loop, when it runs.

This test process has jax loaded already (tests/conftest.py), so the check
runs in a fresh interpreter: it imports every module of the port, runs the
CPU slice once (json-only predict on fixture copies, mono and stereo, f32
and int8, mono with MC dropout and both activities, f32 and bf16, and
--mode keypoints), runs each bench leg, ablation variant, the roofline
tool's rows and the latency and crossover tools once at a toy size, serves
one request over HTTP, writes a synthetic KITTI root with images, runs `eval
--generate` and the scoring, `prep` and `train` on it and the eval parity
tool (whose legs are interpreters of their own), `train --resume`,
`train --hyp` (stacked), `prep --activity` and `eval --activity`, `eval
--geometric`, `eval --variance` (as on a machine without matplotlib),
`eval --generate --baselines` (mono, and stereo with the tiny ReID), `eval
--generate --dp_devices 2` (stereo, a gloo mesh of two processes) and a
json-only `predict --webcam` on stub
cv2 and openpifpaf, and then asserts that none of jax, jaxlib, optax,
orbax, matplotlib, PIL and openpifpaf is in sys.modules (nor tabulate,
yaml or cv2
after the imports: EvalKitti imports tabulate only to print its table,
where there is one).

Each driver of the JAX package's `tools/` that the port carries
(`DRIVERS`) is imported alone in a fresh interpreter, which must then hold
no jax, jaxlib, optax, orbax or `monoloco_tpu` module and nothing loaded
from `tools/`; and, with no card and no `--disable-cuda`, each raises
before it runs anything on the CPU (no subprocess, no file written).
"""

import importlib
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, 'monoloco_tpu_torch')

_SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, shutil, sys, tempfile
    import monoloco_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(monoloco_tpu_torch.__path__,
                                                   'monoloco_tpu_torch.')]
    for name in names:
        importlib.import_module(name)
    # Optional at run time (EvalKitti's table), never loaded by an import.
    assert not [m for m in sys.modules if m.split('.')[0] in ('tabulate', 'yaml', 'cv2')]
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.network import engine
    here, model = sys.argv[1], sys.argv[2]
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(3):
            dst = os.path.join(tmp, f'im{i}.png')
            shutil.copy(os.path.join(here, 'fixture_002282.png'), dst)
            shutil.copy(os.path.join(here, 'fixture_002282.pifpaf.json'),
                        dst + '.pifpaf.json')
        args = ['predict', '--glob', os.path.join(tmp, '*.png'), '--model', model,
                '--calibration', 'kitti', '--disable-cuda', '--output_types', 'json']
        net = run_net = run.main(args + ['-o', os.path.join(tmp, 'f32')])
        assert net.n_dispatches == 1 and net.n_dispatches_int8 == 0
        os.environ['MONOLOCO_TPU_PRECISION'] = 'int8'
        engine._INT8_MIN_ROWS = 8
        net = run.main(args + ['-o', os.path.join(tmp, 'int8')])
        assert net.n_dispatches_int8 == 1
        assert len(os.listdir(os.path.join(tmp, 'int8'))) == 3
        mc = ['--n_dropout', '3', '--activities', 'social_distance', 'raise_hand']
        for precision in ('float32', 'bf16'):
            os.environ['MONOLOCO_TPU_PRECISION'] = precision
            net = run.main(args + mc + ['-o', os.path.join(tmp, 'mc' + precision)])
            assert net.mc_last is not None and net.n_dispatches_int8 == 0
        assert run.main(args + ['--mode', 'keypoints', '-o', os.path.join(tmp, 'kps')]) is None
        assert len(os.listdir(os.path.join(tmp, 'kps'))) == 3
    # predict --mode stereo on fixture pairs (the right poses shifted left by
    # 20 px), per-image (1 pair) and batched (3 pairs), f32 then int8.
    import json
    from monoloco_tpu_torch.models import init_loco_params, save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        stereo_model = os.path.join(tmp, 'stereo.pkl')
        save_checkpoint(stereo_model, *init_loco_params(0, 68, 10, 128, 2))
        with open(os.path.join(here, 'fixture_002282.pifpaf.json')) as f:
            anns = json.load(f)
        right = [{**a, 'keypoints': [v - 20 if i % 3 == 0 else v
                                     for i, v in enumerate(a['keypoints'])]} for a in anns]
        for i in range(3):
            for side, poses in (('a', anns), ('b', right)):
                dst = os.path.join(tmp, f'pair{i}{side}.png')
                shutil.copy(os.path.join(here, 'fixture_002282.png'), dst)
                with open(dst + '.pifpaf.json', 'w') as f:
                    json.dump(poses, f)
        pngs = sorted(os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith('.png'))
        for precision, images in (('float32', pngs[:2]), ('float32', pngs), ('int8', pngs)):
            os.environ['MONOLOCO_TPU_PRECISION'] = precision
            out = os.path.join(tmp, f'{precision}{len(images)}')
            net = run.main(['predict', *images, '--mode', 'stereo', '--model', stereo_model,
                            '--calibration', 'kitti', '--disable-cuda', '--output_types',
                            'json', '-o', out])
            assert net.n_dispatches == 1 and len(os.listdir(out)) == len(images) // 2
            assert net.n_dispatches_int8 == (precision == 'int8')
    from monoloco_tpu_torch import bench
    from monoloco_tpu_torch.tools import bench_pallas_int8, bench_roofline
    folded = bench.bench_folded(hidden=128, device='cpu')
    for leg in ('bf16', 'f32', 'int8', 'int8-a8', 'int8-xla'):
        bench.measure(folded, leg, batch=16, scan_iters=1, device='cpu')
    keypoints, kk = bench.bench_keypoints(16, 'cpu')
    for variant, mlp in bench_pallas_int8.build_mlps(folded).items():
        bench_pallas_int8.measure_variant(variant, mlp, keypoints, kk, 1)
    assert len(bench_roofline.measure_rows(batch=16, peak_n=64, device='cpu', reps=1)) == 4
    from monoloco_tpu_torch.tools import bench_int8_crossover, bench_latency
    assert len(bench_latency.measure(folded, [4], reps=1, warmup=0, device='cpu')) == 4
    bench_int8_crossover.measure_rows(bench_int8_crossover.build_paths(folded), 16, reps=1,
                                      scan_iters=1, device='cpu')
    # The server: one request over HTTP to a CPU engine, and /healthz.
    import threading, urllib.request
    from monoloco_tpu_torch.serve import Server
    srv = Server(run_net, port=0)
    srv.warmup()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    body = json.dumps({'keypoints': [[[100.0] * 17, [200.0] * 17, [1.0] * 17]],
                       'kk': [[718., 0., 600.], [0., 718., 180.], [0., 0., 1.]]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f'http://127.0.0.1:{srv.port}/v1/predict', data=body), timeout=60) as resp:
        assert len(json.loads(resp.read())['outputs']['xyzd']) == 1
    with urllib.request.urlopen(f'http://127.0.0.1:{srv.port}/healthz', timeout=60) as resp:
        assert json.loads(resp.read())['status'] == 'ok'
    srv.shutdown()
    # KITTI txt generation and scoring, and the eval parity tool.
    from monoloco_tpu_torch.tools import eval_parity, make_synthetic_kitti
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_kitti.make_dataset(tmp, n_train=2, n_val=3, seed=0)
        assert len(os.listdir(os.path.join(tmp, 'data', 'kitti', 'images_r'))) == 5
        old = os.getcwd()
        os.chdir(tmp)
        try:
            gen, ev = run.main(['eval', '--generate', '--dir_ann', 'annotations', '--model',
                                model, '--disable-cuda'])
            assert len(os.listdir(os.path.join('data', 'kitti', 'monoloco_pp'))) == 3
            assert os.path.exists(ev.path_results)
            # prep (image sizes from the PNG headers) and training, on the CPU.
            prep = run.main(['prep', '--dir_ann', 'annotations'])
            trainer = run.main(['train', '--joints', prep.path_joints, '--epochs', '1',
                                '--hidden_size', '16', '--n_stage', '1', '--out', 'm.pkl',
                                '--disable-cuda'])
            assert os.path.exists('m.pkl') and trainer.best_epoch == 0
            small = ['--hidden_size', '16', '--n_stage', '1', '--disable-cuda']
            trainer = run.main(['train', '--joints', prep.path_joints, '--epochs', '2',
                                '--out', 'r.pkl', '--resume', 'm.pkl', *small])
            assert trainer.start_epoch == 1 and os.path.exists('r.pkl')
            os.environ['MONOLOCO_TPU_HYP_PARALLEL'] = '1'
            from monoloco_tpu_torch.train import hyp_tuning
            real_init = hyp_tuning.HypTuning.__init__
            def shrink(self, *a, **k):
                real_init(self, *a, **k)
                self.hidden_list = [16] * 6
                self.bs_list = [64] * 6
            hyp_tuning.HypTuning.__init__ = shrink
            best = run.main(['train', '--joints', prep.path_joints, '--hyp', '--epochs', '1',
                             '--monocular', *small])
            hyp_tuning.HypTuning.__init__ = real_init
            assert 'acc_val' in best
            # The eval verticals.
            run.main(['prep', '--dir_ann', 'annotations', '--activity'])
            ev = run.main(['eval', '--activity', '--dir_ann', 'annotations', '--model', model,
                           '--disable-cuda'])
            assert ev.all_pred['all']
            assert 'all' in run.main(['eval', '--geometric', '--joints', prep.path_joints])
            shutil.copy(os.path.join(here, 'fixture_joints-kitti-stereo.json'), 'v_pifpaf.json')
            sys.modules['matplotlib'] = None            # as where matplotlib is missing
            assert list(run.main(['eval', '--variance', '--joints', 'v'])) == ['pifpaf']
            del sys.modules['matplotlib']
            from monoloco_tpu_torch.eval import GenerateKitti
            from monoloco_tpu_torch.models import init_monoloco_params
            save_checkpoint(GenerateKitti.monoloco_checkpoint,
                            *init_monoloco_params(0, 34, 2, 256, 1))
            gen, ev = run.main(['eval', '--generate', '--baselines', '--dir_ann', 'annotations',
                                '--model', model, '--disable-cuda'])
            assert {'monoloco', 'geometric', 'monoloco_pp'} <= set(ev.methods)
            # The stereo baselines: the tiny ReID on the crops the port decodes
            # and resizes itself (no Pillow), then generation over a dp2 mesh.
            from monoloco_tpu_torch.models import init_loco_params
            params, bn = init_loco_params(0, 68, 10, 16, 1)
            params['w_fin']['b'][0:3] += 15.0
            save_checkpoint('stereo.pkl', params, bn)
            stereo = ['--mode', 'stereo', '--dir_ann', 'annotations', '--model', 'stereo.pkl',
                      '--hidden_size', '16', '--n_stage', '1', '--disable-cuda']
            gen, ev = run.main(['eval', '--generate', '--baselines', *stereo, '--reid_weights',
                                os.path.join(here, 'fixture_tiny_reid.pkl')])
            assert {'pose', 'reid', 'monstereo'} <= set(ev.methods) and gen.reid_net.pretrained
            gen, ev = run.main(['eval', '--generate', *stereo, '--dp_devices', '2'])
            assert gen.model.mesh.dp == 2
            # predict --webcam, json only, on stub cv2 and openpifpaf.
            import types
            import numpy as np
            cv2 = types.ModuleType('cv2')
            frames = [np.zeros((48, 64, 3), np.uint8)] * 2
            class Capture:
                def __init__(self, *_):
                    self.left = list(frames)
                def isOpened(self):
                    return True
                def read(self):
                    return (True, self.left.pop()) if self.left else (False, None)
            cv2.VideoCapture, cv2.COLOR_BGR2RGB = Capture, 4
            cv2.resize = lambda img, _n, fx=1.0, fy=1.0: img
            cv2.cvtColor = lambda img, code: img
            pifpaf = types.ModuleType('openpifpaf')
            with open(os.path.join(here, 'fixture_002282.pifpaf.json')) as f:
                fixture_anns = json.load(f)
            class Ann:
                def __init__(self, data):
                    self.data = data
                def json_data(self):
                    return self.data
            class Predictor:
                def __init__(self, checkpoint=None):
                    pass
                def numpy_images(self, images):
                    yield [Ann(a) for a in fixture_anns], None, None
            pifpaf.Predictor = Predictor
            sys.modules['cv2'], sys.modules['openpifpaf'] = cv2, pifpaf
            net, n_frames = run.main(['predict', '--webcam', '--model', model,
                                      '--output_types', 'json', '--disable-cuda'])
            del sys.modules['cv2'], sys.modules['openpifpaf']
            assert n_frames == 2 and os.path.exists('out_webcam_1.monoloco.json')
        finally:
            os.chdir(old)
        rec = eval_parity.main([tmp, '--model', model, '--disable-cuda'])
        assert rec['legs']['int8']['dispatches_int8'] == 1
        assert rec['txt_row_diff']['bf16']['rows'] > 0
    print('NAMES', ' '.join(names))
    leaked = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'matplotlib',
                                           'PIL', 'cv2', 'openpifpaf'))
    print('MODULES', len(names), 'LEAKED', leaked)
    assert not leaked, leaked
""")


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run(
        [sys.executable, '-c', _SCRIPT, HERE,
         os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert 'LEAKED []' in res.stdout
    n_modules = int(re.search(r'MODULES (\d+)', res.stdout).group(1))
    assert n_modules >= 42
    names = set(re.search(r'NAMES (.*)', res.stdout).group(1).split())
    assert {'monoloco_tpu_torch.bench', 'monoloco_tpu_torch.ops.quant',
            'monoloco_tpu_torch.geometry.stereo',
            'monoloco_tpu_torch.tools.bench_pallas_int8',
            'monoloco_tpu_torch.tools.bench_pallas_crossover',
            'monoloco_tpu_torch.tools.bench_roofline', 'monoloco_tpu_torch.activity',
            'monoloco_tpu_torch.serve', 'monoloco_tpu_torch.tools.bench_serve',
            'monoloco_tpu_torch.tools.bench_latency',
            'monoloco_tpu_torch.tools.bench_int8_crossover',
            'monoloco_tpu_torch.visuals.printer', 'monoloco_tpu_torch.visuals.pifpaf_show',
            'monoloco_tpu_torch.eval.generate_kitti', 'monoloco_tpu_torch.eval.eval_kitti',
            'monoloco_tpu_torch.prep.preprocess_kitti', 'monoloco_tpu_torch.utils.kitti',
            'monoloco_tpu_torch.utils.misc', 'monoloco_tpu_torch.tools.make_synthetic_kitti',
            'monoloco_tpu_torch.tools.eval_parity', 'monoloco_tpu_torch.prep.transforms',
            'monoloco_tpu_torch.prep.preprocess_nu', 'monoloco_tpu_torch.utils.nuscenes',
            'monoloco_tpu_torch.utils.logs', 'monoloco_tpu_torch.train',
            'monoloco_tpu_torch.train.losses', 'monoloco_tpu_torch.train.datasets',
            'monoloco_tpu_torch.train.trainer', 'monoloco_tpu_torch.train.hyp_tuning',
            'monoloco_tpu_torch.eval.geom_baseline', 'monoloco_tpu_torch.eval.eval_variance',
            'monoloco_tpu_torch.eval.stereo_baselines', 'monoloco_tpu_torch.eval.eval_activity',
            'monoloco_tpu_torch.visuals.figures', 'monoloco_tpu_torch.visuals.plot_3d_box',
            'monoloco_tpu_torch.visuals.webcam', 'monoloco_tpu_torch.eval.reid_baseline',
            'monoloco_tpu_torch.utils.image', 'monoloco_tpu_torch.parallel',
            'monoloco_tpu_torch.parallel.mesh', 'monoloco_tpu_torch.parallel.launch',
            'monoloco_tpu_torch.parallel.dryrun'} <= names


def test_no_jax_import_statement_in_the_port():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|optax|orbax|monoloco_tpu)(\.|\s|$)',
                         re.M)
    offenders = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith('.py'):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


# Each driver's arguments for a run that would do work: ROOT and OUT stand
# for paths under the test's tmp_path.
DRIVERS = {
    'bench_variance': ['3'],
    'bench_int8_roofline': [],
    'bench_generate_full_scale': ['ROOT', '--n_val', '2'],
    'bench_cli_phases': ['--out', 'OUT'],
    'bench_hyp_search': ['core'],
    'bench_mesh_scaling': ['--widths', '1'],
    'train_tiny_reid': ['OUT'],
}

_IMPORT_ONE = textwrap.dedent("""
    import importlib, os, sys
    importlib.import_module(sys.argv[1])
    tools = os.path.join(sys.argv[2], 'tools') + os.sep
    leaked = sorted(name for name, mod in list(sys.modules.items())
                    if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'monoloco_tpu')
                    or (getattr(mod, '__file__', None) or '').startswith(tools))
    print('LEAKED', leaked)
""")


@pytest.mark.parametrize('driver', sorted(DRIVERS))
def test_driver_imports_without_jax(driver):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _IMPORT_ONE,
                          f'monoloco_tpu_torch.tools.{driver}', REPO],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'LEAKED []' in res.stdout, res.stdout


@pytest.mark.parametrize('driver', sorted(DRIVERS))
def test_driver_refuses_the_cpu_without_disable_cuda(driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)

    def no_subprocess(*args, **kwargs):
        raise AssertionError(f'{driver} started a subprocess: {args}')

    monkeypatch.setattr(subprocess, 'run', no_subprocess)
    paths = {'ROOT': str(tmp_path / 'root'), 'OUT': str(tmp_path / 'out.pkl')}
    argv = [paths.get(a, a) for a in DRIVERS[driver]]
    module = importlib.import_module(f'monoloco_tpu_torch.tools.{driver}')
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main(argv)
    assert os.listdir(tmp_path) == []
