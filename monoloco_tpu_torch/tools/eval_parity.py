"""Do the port's serving precisions hold the END metric (ALE/ALP), and does
a model the port trained score the JAX package's?

The port of the JAX package's `tools/int8_eval_parity.py`. It runs
GenerateKitti + EvalKitti once per precision on a KITTI-layout root
(`data/kitti/gt`, `data/kitti/calib`, `annotations/`, `splits/`, as
`monoloco_tpu_torch.tools.make_synthetic_kitti` writes it), each in a fresh
subprocess with MONOLOCO_TPU_PRECISION set, since that is how a user
selects it. The txt trees are then diffed row by row against the float32
tree: the detections and their order are the same in every tree, so
per-row distance deltas isolate the serving arithmetic (dyn8 under int8,
K1-bf16 under bf16). Every detection is scored (the method's confidence
floor set to -100, as the JAX tool does), so ALE and ALP see every row the
precisions move.

With `--train` it first builds ROOT and trains the checkpoint, each stage in
its own subprocess, as the JAX tool's setup and train stages
(`tools/int8_eval_parity.py:52-77`, `tools/head_to_head.py:40-80`): the
hard synthetic KITTI of dataset seed 7 (mono) or 8 (stereo) at `--n_train`
+ `--n_val` scenes, the three bad KITTI ids added to the train split with
empty gt files, PreprocessKitti, and the Trainer at the reference's
production configuration (bs 512, dropout 0.2, lr 0.002 mono / 0.003
stereo, sched_step 30, gamma 0.98, hidden 1024, 3 stages, `--epochs` 500,
`--r_seed`), whose `evaluate()` writes ROOT/data/outputs/eval_parity.pkl.
The float32 leg is then held beside the JAX package's records of the same
setup (`JAX_REFERENCE`, read from nothing at run time).

Usage: python -m monoloco_tpu_torch.tools.eval_parity ROOT --model CKPT
           [--mode mono|stereo] [--disable-cuda]
       python -m monoloco_tpu_torch.tools.eval_parity ROOT --train
           [--mode mono|stereo] [--n_train N] [--n_val N] [--epochs E]
           [--r_seed S] [--disable-cuda]

Prints one JSON line: per precision (float32, int8, bf16) ALE (easy,
moderate, hard, all), ALP (<0.5, <1, <2 m), matched rows, dispatches,
dyn8-routed dispatches, kernel launches, generation wall and images/s; for
int8 and bf16 the relative ALE change and the row diff against float32.
With --train also the scenes, the training rows, epochs and r_seed, the
training wall and samples/s, the JAX reference of the mode and the float32
leg's distance from it.
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
DATASET_SEED = {'mono': 7, 'stereo': 8}      # tools/head_to_head.py:40
BAD_KITTI_IDS = ('000518', '005692', '003009')
MODEL_NAME = 'eval_parity.pkl'
# The JAX package's ALE/ALP after training at full synthetic volume (hard
# mode, hidden 1024, 3 stages, bs 512, 500 epochs), from
# tools/int8_eval_parity_r4.jsonl: mono 2400 + 2400 scenes, lines 3, 5 and 8
# (training seeds 1, 2, 3); stereo 928 + 942 scenes, lines 4, 6 and 7
# (seeds 1, 2, 3). Each line's reference leg ("bf16"), its ALE (all) and
# ALP <1m, and the mean of the three.
_JAX_RUNS = {
    'mono': {'ale_all': (1.2889138026781157, 1.2914658056189199, 1.2906276922760582),
             'alp_1m': (42.392613408269774, 42.322360497792054, 42.422721798474505),
             'matched': 7253, 'n_train': 2400, 'n_val': 2400,
             'lines': 'tools/int8_eval_parity_r4.jsonl:3,5,8'},
    'stereo': {'ale_all': (0.7621058795418899, 0.767359609637234, 0.7546923104601638),
               'alp_1m': (56.423952769187515, 56.31149845375316, 56.59263424233905),
               'matched': 2622, 'n_train': 928, 'n_val': 942,
               'lines': 'tools/int8_eval_parity_r4.jsonl:4,6,7'},
}
JAX_REFERENCE = {mode: dict(run, ale_all_mean=sum(run['ale_all']) / 3,
                            alp_1m_mean=sum(run['alp_1m']) / 3)
                 for mode, run in _JAX_RUNS.items()}


def make_root(root, mode, n_train, n_val):
    """The JAX head-to-head's root (`tools/head_to_head.py:make_root`): the
    hard synthetic KITTI of the mode's dataset seed, the work directories,
    and the three bad KITTI ids (the reference's split_training drops them
    from the train split) with empty gt files."""
    from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset
    shutil.rmtree(root, ignore_errors=True)
    make_dataset(root, n_train=n_train, n_val=n_val, seed=DATASET_SEED[mode], hard=True)
    for sub in (('data', 'arrays'), ('data', 'outputs'), ('data', 'logs'),
                ('data', 'models'), ('figures', 'results')):
        os.makedirs(os.path.join(root, *sub), exist_ok=True)
    with open(os.path.join(root, 'splits', 'kitti_train.txt'), 'a') as f:
        f.write('\n'.join(BAD_KITTI_IDS) + '\n')
    for b in BAD_KITTI_IDS:
        open(os.path.join(root, 'data', 'kitti', 'gt', b + '.txt'), 'w').close()


def train_args(mode, seed, path_joints, out, epochs, disable_cuda):
    """The Trainer's arguments of the JAX head-to-head (`train_args`)."""
    return argparse.Namespace(
        joints=path_joints, mode=mode, out=out, epochs=epochs, bs=512, dropout=0.2,
        lr=0.002 if mode == 'mono' else 0.003, sched_step=30, sched_gamma=0.98,
        hidden_size=1024, n_stage=3, r_seed=seed, auto_tune_mtl=False, no_save=False,
        print_loss=False, resume=None, profile=None, disable_cuda=disable_cuda)


def stage_setup(root, mode, n_train, n_val, out_json):
    """Build ROOT and run PreprocessKitti; the joints file's path goes to
    out_json."""
    from monoloco_tpu_torch.prep import PreprocessKitti
    t0 = time.perf_counter()
    make_root(root, mode, n_train, n_val)
    os.chdir(root)
    path_joints, _ = PreprocessKitti(dir_ann='annotations', mode=mode, iou_min=0.3).run()
    with open(out_json, 'w') as f:
        json.dump({'joints': os.path.abspath(path_joints),
                   'setup_wall_s': time.perf_counter() - t0}, f)


def stage_train(root, mode, joints, epochs, r_seed, disable_cuda, out_json):
    """Train on the joints and save ROOT/data/outputs/eval_parity.pkl
    (`evaluate()` writes it); the training record goes to out_json."""
    from monoloco_tpu_torch.train import Trainer
    os.chdir(root)
    args = train_args(mode, r_seed, joints, os.path.join('data', 'outputs', MODEL_NAME), epochs,
                      disable_cuda)
    trainer = Trainer(args)
    t0 = time.perf_counter()
    trainer.train()
    if trainer.device.type == 'cuda':
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer.evaluate()
    with open(out_json, 'w') as f:
        json.dump({'n_train_rows': trainer.n_train, 'n_val_rows': trainer.dataset_sizes['val'],
                   'train_wall_s': wall, 'samples_per_s': trainer.n_train * epochs / wall,
                   'best_epoch': trainer.best_epoch, 'best_val_d': trainer.best_acc,
                   'device': str(trainer.device)}, f)


def _run_stage(stage_args, env=None):
    """`python -m monoloco_tpu_torch.tools.eval_parity --stage ...` in a
    fresh interpreter; exits with its output's tail when it fails."""
    env = dict(os.environ if env is None else env)
    env['PYTHONPATH'] = os.pathsep.join(p for p in (REPO, env.get('PYTHONPATH')) if p)
    cmd = [sys.executable, '-m', 'monoloco_tpu_torch.tools.eval_parity', '--stage',
           *stage_args]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-4000:])
        raise SystemExit(f'stage {stage_args[0]} failed (rc={res.returncode})')


def train_root(root, mode, n_train, n_val, epochs, r_seed, disable_cuda):
    """The setup and train stages, each in its own interpreter; returns
    (the checkpoint, the merged setup and training record)."""
    root = os.path.abspath(root)
    setup_json = os.path.join(root, 'setup.json')      # written once ROOT is built
    _run_stage(['setup', root, '--mode', mode, '--n_train', str(n_train), '--n_val', str(n_val),
                '--out-json', setup_json])
    with open(setup_json) as f:
        rec = json.load(f)
    train_json = os.path.join(root, 'train.json')
    _run_stage(['train', root, '--mode', mode, '--joints', rec['joints'], '--epochs',
                str(epochs), '--r_seed', str(r_seed), '--out-json', train_json]
               + (['--disable-cuda'] if disable_cuda else []))
    with open(train_json) as f:
        rec.update(json.load(f))
    return os.path.join(root, 'data', 'outputs', MODEL_NAME), rec


def vs_jax(mode, leg):
    """A leg's distance from the JAX package's records of the mode: ALE
    (all) in % of the JAX mean, ALP <1m in points, matched rows."""
    ref = JAX_REFERENCE[mode]
    return {'ale_all_pct': 100.0 * (leg['ale']['all'] - ref['ale_all_mean']) / ref['ale_all_mean'],
            'alp_1m_points': leg['alp']['<1m'] - ref['alp_1m_mean'],
            'matched': leg['matched'] - ref['matched']}


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
    _run_stage(['geneval', os.path.abspath(root), '--model', os.path.abspath(model), '--mode',
                mode, '--out-json', out_json] + (['--disable-cuda'] if disable_cuda else []),
               env=dict(os.environ, MONOLOCO_TPU_PRECISION=precision))
    with open(out_json) as f:
        return json.load(f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('root')
    parser.add_argument('--model', help='the checkpoint (--train: the one it trains)')
    parser.add_argument('--mode', default='mono', choices=('mono', 'stereo'))
    parser.add_argument('--train', action='store_true',
                        help='build ROOT and train the checkpoint first')
    parser.add_argument('--n_train', type=int, help='train scenes (mono 2400, stereo 928)')
    parser.add_argument('--n_val', type=int, help='val scenes (mono 2400, stereo 942)')
    parser.add_argument('--epochs', type=int, default=500)
    parser.add_argument('--r_seed', type=int, default=1, help='the training seed')
    parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true')
    parser.add_argument('--stage', choices=('setup', 'train', 'geneval'),
                        help=argparse.SUPPRESS)
    parser.add_argument('--joints', help=argparse.SUPPRESS)
    parser.add_argument('--out-json', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    ref_run = JAX_REFERENCE[args.mode]
    n_train = args.n_train or ref_run['n_train']
    n_val = args.n_val or ref_run['n_val']
    if args.stage == 'setup':
        stage_setup(args.root, args.mode, n_train, n_val, args.out_json)
        return None
    if args.stage == 'train':
        stage_train(args.root, args.mode, args.joints, args.epochs, args.r_seed,
                    args.disable_cuda, args.out_json)
        return None
    if args.stage == 'geneval':
        stage_geneval(args.root, args.model, args.mode, args.disable_cuda, args.out_json)
        return None
    if not (args.train or args.model):
        parser.error('--model is required without --train')
    t0 = time.perf_counter()
    train_rec = None
    if args.train:
        args.model, train_rec = train_root(args.root, args.mode, n_train, n_val, args.epochs,
                                           args.r_seed, args.disable_cuda)
    legs = {p: run_leg(args.root, args.model, args.mode, p, args.disable_cuda)
            for p in PRECISIONS}
    ref = legs['float32']
    rec = {'mode': args.mode, 'model': os.path.basename(args.model), 'legs': legs,
           'ale_all_delta_pct': {}, 'txt_row_diff': {}}
    if train_rec is not None:
        rec.update(n_train=n_train, n_val=n_val, epochs=args.epochs, r_seed=args.r_seed,
                   **train_rec)
        rec['jax_reference'] = ref_run
        rec['vs_jax'] = vs_jax(args.mode, ref)
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
