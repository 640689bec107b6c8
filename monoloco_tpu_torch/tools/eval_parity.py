"""Do the port's serving precisions hold the END metric (ALE/ALP)?

The port of the JAX package's `tools/int8_eval_parity.py`, without its
dataset and training stages: it takes a trained checkpoint and a KITTI-layout
root (`data/kitti/gt`, `data/kitti/calib`, `annotations/`, `splits/`, as
`monoloco_tpu_torch.tools.make_synthetic_kitti` writes it), and runs
GenerateKitti + EvalKitti once per precision, each in a fresh subprocess with
MONOLOCO_TPU_PRECISION set, since that is how a user selects it. The txt
trees are then diffed row by row against the float32 tree: the detections
and their order are the same in every tree, so per-row distance deltas
isolate the serving arithmetic (dyn8 under int8, K1-bf16 under bf16).

Every detection is scored (the method's confidence floor set to -100, as
the JAX tool does), so ALE and ALP see every row the precisions move.

Usage: python -m monoloco_tpu_torch.tools.eval_parity ROOT --model CKPT
           [--mode mono|stereo] [--disable-cuda]
Prints one JSON line: per precision (float32, int8, bf16) ALE (easy,
moderate, hard, all), ALP (<0.5, <1, <2 m), matched rows, dispatches,
dyn8-routed dispatches, kernel launches, generation wall and images/s; for
int8 and bf16 the relative ALE change and the row diff against float32.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ALP_GATES = ('<0.5m', '<1m', '<2m')
PRECISIONS = ('float32', 'int8', 'bf16')     # float32 first: the reference leg


def eval_args(mode, model, disable_cuda):
    return argparse.Namespace(
        mode=mode, model=model, dir_ann='annotations', n_dropout=0, dropout=0.2,
        hidden_size=1024, n_stage=3, baselines=False, generate_official=False,
        verbose=False, save=False, show=False, disable_cuda=disable_cuda)


def extract_metrics(ev, net):
    """ALE per cluster, ALP per gate (in %) and the matched rows of one net."""
    ale = {clst: float(ev.dic_stats['test'][net][clst]['mean'])
           for clst in ('easy', 'moderate', 'hard', 'all')}
    alp = {gate: 100.0 * sum(ev.errors[net][gate]) / max(len(ev.errors[net][gate]), 1)
           for gate in ALP_GATES}
    return {'ale': ale, 'alp': alp, 'matched': len(ev.errors[net]['all'])}


def stage_geneval(root, model, mode, disable_cuda, out_json):
    """One precision (the environment's): generate, score, copy the txt tree
    to ROOT/txt_<precision>, and write the metrics to out_json."""
    from monoloco_tpu_torch.eval import EvalKitti, GenerateKitti
    from monoloco_tpu_torch.ops import launches
    os.chdir(root)
    args = eval_args(mode, os.path.abspath(model), disable_cuda)
    gen = GenerateKitti(args)
    t0 = time.perf_counter()
    gen.run()
    wall = time.perf_counter() - t0
    ev = EvalKitti(args)
    ev.dic_thresh_conf[gen.net] = -100
    ev.run()
    net = gen.model
    n_images = len(os.listdir(os.path.join('data', 'kitti', gen.net)))
    rec = extract_metrics(ev, gen.net)
    rec.update(precision=net.precision, n_images=n_images, wall_s=wall,
               images_per_s=n_images / wall, dispatches=net.n_dispatches,
               dispatches_int8=net.n_dispatches_int8,
               launches={k: v for k, v in launches.items() if v})
    dst = f'txt_{net.precision}'
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join('data', 'kitti', gen.net), dst)
    with open(out_json, 'w') as f:
        json.dump(rec, f)


def txt_tree_diff(dir_a, dir_b):
    """Row-wise relative |delta| of the distance (the norm of xyz, columns
    11:14) between two txt trees of the same detections; raises unless both
    hold the same files, the same rows in the same order, and equal text
    columns and boxes."""
    import numpy as np
    names = sorted(os.listdir(dir_a))
    if names != sorted(os.listdir(dir_b)):
        raise AssertionError(f'{dir_a} and {dir_b} hold different files')
    deltas = []
    for name in names:
        with open(os.path.join(dir_a, name)) as fa, open(os.path.join(dir_b, name)) as fb:
            rows_a, rows_b = fa.readlines(), fb.readlines()
        if len(rows_a) != len(rows_b):
            raise AssertionError(f'{name}: row count differs')
        for ra, rb in zip(rows_a, rows_b):
            fa_, fb_ = ra.split(), rb.split()
            if fa_[:3] + fa_[4:8] != fb_[:3] + fb_[4:8]:
                raise AssertionError(f'{name}: another detection in a row')
            da = np.linalg.norm(np.array(fa_[11:14], float))
            db = np.linalg.norm(np.array(fb_[11:14], float))
            if da > 0:
                deltas.append(abs(db - da) / da)
    deltas = np.asarray(deltas)
    return {'rows': int(deltas.size), 'mean_rel_dd': float(deltas.mean()),
            'p99_rel_dd': float(np.percentile(deltas, 99)), 'max_rel_dd': float(deltas.max())}


def run_leg(root, model, mode, precision, disable_cuda):
    """One precision in a fresh interpreter; returns its metrics."""
    out_json = os.path.join(os.path.abspath(root), f'metrics_{precision}.json')
    env = dict(os.environ, MONOLOCO_TPU_PRECISION=precision,
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    cmd = [sys.executable, '-m', 'monoloco_tpu_torch.tools.eval_parity', '--stage',
           os.path.abspath(root), '--model', os.path.abspath(model), '--mode', mode,
           '--out-json', out_json] + (['--disable-cuda'] if disable_cuda else [])
    res = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-4000:])
        raise SystemExit(f'{precision} leg failed (rc={res.returncode})')
    with open(out_json) as f:
        return json.load(f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('root')
    parser.add_argument('--model', required=True)
    parser.add_argument('--mode', default='mono', choices=('mono', 'stereo'))
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    parser.add_argument('--stage', action='store_true', help=argparse.SUPPRESS)
    parser.add_argument('--out-json', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.stage:
        stage_geneval(args.root, args.model, args.mode, args.disable_cuda, args.out_json)
        return None
    t0 = time.perf_counter()
    legs = {p: run_leg(args.root, args.model, args.mode, p, args.disable_cuda)
            for p in PRECISIONS}
    ref = legs['float32']
    rec = {'mode': args.mode, 'model': os.path.basename(args.model), 'legs': legs,
           'ale_all_delta_pct': {}, 'txt_row_diff': {}}
    for p in PRECISIONS[1:]:
        canon = legs[p]['precision']
        rec['ale_all_delta_pct'][p] = 100.0 * (legs[p]['ale']['all'] - ref['ale']['all']) \
            / ref['ale']['all']
        rec['txt_row_diff'][p] = txt_tree_diff(os.path.join(args.root, 'txt_float32'),
                                               os.path.join(args.root, f'txt_{canon}'))
    rec['wall_s'] = time.perf_counter() - t0
    print(json.dumps(rec))
    return rec


if __name__ == '__main__':
    main()
