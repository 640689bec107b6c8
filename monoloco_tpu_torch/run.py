"""CLI entry point: python -m monoloco_tpu_torch.run predict|prep|train|eval ...

The flags of `monoloco_tpu.run`, so that a JAX command line runs on the
port unchanged, plus `--disable-cuda` (without it predict, train and `eval
--generate` need a CUDA card).

predict: the pifpaf passthroughs (`--long-edge`, `--white-overlay`,
`--font-size`, `--monocolor-connections`, `--instance-threshold`,
`--seed-threshold`, `--precise-rescaling`, `--decoder-workers`) go to
OpenPifPaf's `configure` hooks when an image has no pifpaf JSON and
OpenPifPaf runs on it (`predict.run_pifpaf`, with `--checkpoint`). `--webcam`
runs the live loop (`visuals/webcam.py`: cv2 capture from `--camera`,
OpenPifPaf with `--checkpoint`, the net on the card); without cv2 or
openpifpaf it exits naming the missing one.

eval, from the root of a KITTI layout (`data/kitti/gt`, `data/kitti/calib`,
`splits/`): `--generate` writes `data/kitti/monoloco_pp/*.txt`
(`--mode stereo`: `data/kitti/monstereo/`) with GenerateKitti, with
`--baselines` also the `monoloco` and `geometric` trees (stereo: and the
`pose` and `reid` trees, the ReID net's weights from `--reid_weights`),
and with `--dp_devices N` over a mesh of N ranks (one process a device;
rank 0 writes), then
`--dataset kitti` (the default) scores every method folder present with
EvalKitti, prints the summary table and writes `data/logs/eval-<stamp>.json`;
`--save`/`--show` draw its figures (matplotlib). Scoring alone is host code
and needs no card. `--dataset nuscenes` runs the Trainer's `evaluate` on
`--joints` with the checkpoint `--model` (on the card unless
`--disable-cuda`). `--activity` (`--dataset kitti` or `collective`, with
`--dir_ann` and `--model`) runs the ActivityEvaluator; `--geometric` and
`--variance` study `--joints` on the host.

prep (host code, no device): from the root of a KITTI layout,
`prep --dir_ann annotations [--mode stereo]` writes
`data/arrays/joints-kitti-<mode>-<stamp>.json` and `names-...json` with
PreprocessKitti; `--activity` writes the val split's gt files with a
social-distance flag into `data/kitti/gt_activity` instead;
`--dataset nuscenes|nuscenes_mini|nuscenes_teaser` runs PreprocessNuscenes
(it needs the nuScenes devkit). `--variance` is accepted and inert, as in
the JAX CLI.

train: the JAX flags plus `--disable-cuda`; it trains on the card unless
`--disable-cuda` is given, and never falls back to the CPU. `--resume CKPT`
continues a run (the port's checkpoints carry Adam's state, the update
count and the generator; a JAX-written one its optax moments); `--hyp`
runs HypTuning (`--multiplier`, `--r_seed`, `--monocular`;
MONOLOCO_TPU_HYP_PARALLEL=1 trains each (bs, hidden, n_stage) group of
trials as one stacked model); `--dp_devices N [--tp_devices M]` trains on
a mesh of N x M ranks, one process a device (`parallel/launch.py`: NCCL on
the card, gloo with `--disable-cuda`), and computes what one device
computes. Refused: `.orbax` paths (orbax imports jax; ROADMAP "Not to
port").

A mesh flag given, even `--dp_devices 1`, builds a mesh (for 1, a process
group of this process alone); without one no process group is made, which
is what the JAX CLI does for 1. Both compute the same.
"""

import argparse
import importlib.util
import os


def _camera_source(value):
    """A device index, or a video file path."""
    return int(value) if value.lstrip('-').isdigit() else value


def cli(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    subparsers = parser.add_subparsers(help='Different parsers for main actions',
                                       dest='command')
    predict_parser = subparsers.add_parser("predict")
    prep_parser = subparsers.add_parser("prep")
    training_parser = subparsers.add_parser("train")
    eval_parser = subparsers.add_parser("eval")

    add = predict_parser.add_argument
    add('images', nargs='*', help='input images')
    add('--glob', help='glob expression for input images')
    add('--checkpoint', help='pifpaf model, for the images without a pifpaf JSON and '
        'for --webcam')
    add('--json_dir', help='directory of precomputed pifpaf json files')
    add('-o', '--output-directory', dest='output_directory', help='Output directory')
    add('--output_types', nargs='+', default=[],
        help='what to output: json bird front or multi (default multi; front bird with '
             '--activities)')
    add('--json-output', default=None, nargs='?', const=True,
        help='whether to output a pifpaf json file')
    add('--no_save', help='to show images', action='store_true')
    add('--hide_distance', help='hide absolute distances', default=False, action='store_true')
    add('--dpi', help='image resolution', type=int, default=100)
    add('--long-edge', dest='long_edge', default=None, type=int,
        help='rescale the long side of the image (inert)')
    add('--white-overlay', nargs='?', default=False, const=0.8, type=float,
        help='increase contrast to annotations by making image whiter (inert)')
    add('--font-size', dest='font_size', default=0, type=int, help='annotation font size (inert)')
    add('--monocolor-connections', dest='monocolor_connections', default=False,
        action='store_true', help='use a single color per instance (inert)')
    add('--instance-threshold', dest='instance_threshold', type=float, default=None,
        help='threshold for entire instance (inert)')
    add('--seed-threshold', dest='seed_threshold', type=float, default=0.5,
        help='threshold for single seed (inert)')
    add('--disable-cuda', dest='disable_cuda', action='store_true',
        help='run on the CPU; without it predict needs a CUDA card')
    add('--precise-rescaling', dest='fast_rescaling', default=True, action='store_false',
        help='use more exact image rescaling (inert)')
    add('--decoder-workers', default=None, type=int,
        help='number of workers for pose decoding (inert)')
    add('--activities', nargs='+', choices=['raise_hand', 'social_distance'], default=[],
        help='activities to show')
    add('--mode', help='keypoints, mono, stereo', default='mono')
    add('--model', help='path of MonoLoco/MonStereo model to load')
    add('--net', help='only to select older MonoLoco models')
    add('--path_gt', help='path of json file with gt 3d localization')
    add('--z_max', type=int, default=100, help='maximum meters distance for predictions')
    add('--n_dropout', type=int, default=0, help='Epistemic uncertainty evaluation')
    add('--dropout', type=float, default=0.2, help='dropout parameter')
    add('--show_all', action='store_true', help='only predict ground-truth matches or all')
    add('--webcam', help='webcam streaming', action='store_true')
    add('--camera', help='webcam device index, or a video file path',
        type=_camera_source, default=0)
    add('--profile', help='directory for a torch.profiler trace of the run')
    add('--calibration', type=str, default='custom',
        help='camera calibration: custom, nuscenes, or kitti')
    add('--focal_length', type=float, default=5.7,
        help='focal length in mm for a sensor of 7.2x5.4 mm')
    add('--threshold_prob', type=float, default=0.25, help='concordance for samples')
    add('--threshold_dist', type=float, default=2.5, help='min distance of people')
    add('--radii', nargs='+', type=float, default=(0.3, 0.5, 1), help='o-space radii')

    add = prep_parser.add_argument
    add('--dir_ann', required=True, help='directory of annotations of 2d joints')
    add('--mode', help='mono, stereo', default='mono')
    add('--dataset', default='kitti',
        help='datasets to preprocess: nuscenes, nuscenes_teaser, nuscenes_mini, kitti')
    add('--dir_nuscenes', default='data/nuscenes/', help='directory of nuscenes devkit')
    add('--iou_min', type=float, default=0.3, help='minimum iou to match ground truth')
    add('--variance', help='new (inert)', action='store_true')
    add('--activity', help='write the val gt files with a social-distance flag',
        action='store_true')

    add = training_parser.add_argument
    add('--joints', required=True, help='Json file with input joints')
    add('--mode', help='mono, stereo', default='mono')
    add('--out', help='output_path, e.g., data/outputs/test.pkl')
    add('-e', '--epochs', type=int, default=500, help='number of epochs to train for')
    add('--bs', type=int, default=512, help='input batch size')
    add('--monocular', help='whether to train monoloco (with --hyp)', action='store_true')
    add('--dropout', type=float, default=0.2, help='dropout')
    add('--lr', type=float, default=0.002, help='learning rate')
    add('--sched_step', type=float, default=30, help='scheduler step time (batches)')
    add('--sched_gamma', type=float, default=0.98, help='Scheduler multiplication every step')
    add('--hidden_size', type=int, default=1024, help='Number of hidden units in the model')
    add('--n_stage', type=int, default=3, help='Number of stages in the model')
    add('--hyp', help='run hyperparameters tuning', action='store_true')
    add('--multiplier', type=int, default=1, help='Size of the grid of hyp search')
    add('--r_seed', type=int, default=1, help='specify the seed for training')
    add('--print_loss', help='print training and validation losses', action='store_true')
    add('--auto_tune_mtl', action='store_true',
        help='whether to use uncertainty to autotune losses')
    add('--no_save', help='to not save model and log file', action='store_true')
    add('--dp_devices', type=int, default=None,
        help='shard the batch over N devices (data parallelism)')
    add('--tp_devices', type=int, default=None,
        help='shard the hidden dim over N devices (tensor parallelism; total devices = dp*tp)')
    add('--resume', help='checkpoint to resume training from')
    add('--profile', help='directory for a torch.profiler trace of the training')
    add('--disable-cuda', dest='disable_cuda', action='store_true',
        help='train on the CPU; without it train needs a CUDA card')

    add = eval_parser.add_argument
    add('--mode', help='mono, stereo', default='mono')
    add('--dataset', default='kitti', help='datasets to evaluate, kitti or nuscenes')
    add('--activity', help='evaluate activities', action='store_true')
    add('--geometric', help='to evaluate geometric distance', action='store_true')
    add('--generate', help='create txt files for KITTI evaluation', action='store_true')
    add('--dir_ann', help='directory of annotations of 2d joints')
    add('--model', help='path of MonoLoco model to load')
    add('--joints', help='Json file with input joints to evaluate')
    add('--n_dropout', type=int, default=0, help='Epistemic uncertainty evaluation')
    add('--dropout', type=float, default=0.2, help='dropout')
    add('--hidden_size', type=int, default=1024, help='Number of hidden units in the model')
    add('--n_stage', type=int, default=3, help='Number of stages in the model')
    add('--show', help='whether to show statistic graphs', action='store_true')
    add('--save', help='whether to save statistic graphs', action='store_true')
    add('--verbose', help='verbosity of statistics', action='store_true')
    add('--new', help='new', action='store_true')
    add('--variance', help='evaluate keypoints variance', action='store_true')
    add('--net', help='Choose network: monoloco, monoloco_p, monoloco_pp, monstereo')
    add('--baselines', help='whether to evaluate the baselines (monoloco and geometric; '
        'stereo: also pose and reid)', action='store_true')
    add('--reid_weights', default=None,
        help='path to a Market-1501 ReID checkpoint (torch .pkl/.pth, or the tiny_reid-v1 '
             'pickle) for the stereo reid baseline; defaults to '
             'data/models/reid_model_market.pkl if present')
    add('--generate_official', action='store_true',
        help='whether to add empty txt files for official evaluation')
    add('--dp_devices', type=int, default=None,
        help='shard txt generation over N devices (data parallelism)')
    add('--disable-cuda', dest='disable_cuda', action='store_true',
        help='run on the CPU; without it --generate needs a CUDA card')
    return parser.parse_args(argv)


def mesh_shape(args):
    """(dp, tp) of the mesh the flags ask for, or None without a flag."""
    dp, tp = getattr(args, 'dp_devices', None), getattr(args, 'tp_devices', None)
    if dp is None and tp is None:
        return None
    if (dp or 1) < 1 or (tp or 1) < 1:
        raise SystemExit("--dp_devices and --tp_devices take a positive number of devices")
    return dp or 1, tp or 1


def _device_type(args):
    return 'cpu' if getattr(args, 'disable_cuda', False) else 'cuda'


def _generate_worker(mesh, args):
    """GenerateKitti on one rank of the mesh; returns it."""
    from .eval import GenerateKitti
    args.mesh = mesh
    gen = GenerateKitti(args)
    gen.run()
    return gen


def _train_worker(mesh, args):
    """Trainer.train and evaluate on one rank of the mesh; returns the
    Trainer."""
    from .train import Trainer
    args.mesh = mesh
    training = Trainer(args)
    training.train()
    training.evaluate()
    return training


def _require(args, *names):
    for name in names:
        if not getattr(args, name):
            raise SystemExit(f"eval: --{name} is required here")


def eval_activity(args):
    """`eval --activity`: the ActivityEvaluator on `--dataset collective`
    or kitti; returns it."""
    _require(args, 'dir_ann', 'model')
    from .eval.eval_activity import ActivityEvaluator
    evaluator = ActivityEvaluator(args)
    if 'collective' in args.dataset:
        evaluator.eval_collective()
    else:
        evaluator.eval_kitti()
    return evaluator


def eval_geometric(args):
    """`eval --geometric`: the geometric baseline's statistics of
    `--joints`; returns its error per distance cluster."""
    _require(args, 'joints')
    from .eval.geom_baseline import geometric_baseline
    return geometric_baseline(args.joints)


def eval_variance(args):
    """`eval --variance`: the keypoint-disparity study of
    `<joints>_pifpaf.json` and `<joints>_mask.json`; returns its
    statistics."""
    _require(args, 'joints')
    from .eval.eval_variance import joints_variance
    return joints_variance(args.joints, clusters=None, dic_ms=None)


def evaluate(args):
    """`eval`: --activity, --geometric or --variance when given (in that
    order, as the JAX CLI); else GenerateKitti with --generate, then
    EvalKitti for --dataset kitti. Returns the first one's result, or (the
    GenerateKitti (rank 0's on a mesh) or None, the EvalKitti or, for
    nuScenes, the Trainer)."""
    if args.activity:
        return eval_activity(args)
    if args.geometric:
        return eval_geometric(args)
    if args.variance:
        return eval_variance(args)
    if 'nuscenes' not in args.dataset and args.dataset != 'kitti':
        raise ValueError("Option not recognized")
    if (args.save or args.show) and importlib.util.find_spec('matplotlib') is None:
        raise SystemExit("eval --save/--show draw their figures with matplotlib, which is not "
                         "installed here")
    gen = None
    if args.generate:
        from .ops import launches
        shape = mesh_shape(args)
        if shape is None:
            gen = _generate_worker(None, args)
        else:
            from .parallel import launch
            gen = launch(_generate_worker, *shape, args=(args,), device_type=_device_type(args))
        net = gen.model
        print(f"Dispatches: {net.n_dispatches}, through the dyn8 route: "
              f"{net.n_dispatches_int8}, kernel launches: {dict(launches)} "
              f"(precision {net.precision}, device {net.device})")
    if 'nuscenes' in args.dataset:
        return gen, evaluate_nuscenes(args)
    from .eval import EvalKitti
    kitti_eval = EvalKitti(args)
    kitti_eval.run()
    kitti_eval.printer()
    return gen, kitti_eval


def evaluate_nuscenes(args):
    """`eval --dataset nuscenes`: the Trainer's evaluate of `--model` on
    `--joints`' val split; returns the Trainer. The eval namespace lacks the
    training-only flags, which take the training defaults."""
    from .train import Trainer
    for attr, default in (('out', None), ('epochs', 0), ('bs', 512), ('lr', 0.002),
                          ('sched_step', 30), ('sched_gamma', 0.98), ('r_seed', 1),
                          ('auto_tune_mtl', False), ('no_save', True), ('print_loss', False)):
        if not hasattr(args, attr):
            setattr(args, attr, default)
    training = Trainer(args)
    training.evaluate(load=True, model=args.model, debug=False)
    return training


def prep(args):
    """`prep`: PreprocessNuscenes for a nuScenes dataset, else
    PreprocessKitti (`--activity`: the social-distance gt files); returns
    the preprocessor."""
    if 'nuscenes' in args.dataset:
        from .prep.preprocess_nu import PreprocessNuscenes
        preprocessor = PreprocessNuscenes(args.dir_ann, args.dir_nuscenes, args.dataset,
                                          args.iou_min)
        preprocessor.run()
        return preprocessor
    from .prep import PreprocessKitti
    preprocessor = PreprocessKitti(args.dir_ann, mode=args.mode, iou_min=args.iou_min)
    if args.activity:
        preprocessor.process_activity()
    else:
        preprocessor.run()
    return preprocessor


def train(args):
    """`train`: HypTuning under --hyp (returns its best trial's dict), else
    Trainer.train, then evaluate (which saves the checkpoint; returns the
    Trainer)."""
    if not os.path.exists(args.joints):
        raise SystemExit(f"train: --joints {args.joints}: no such file")
    if args.hyp:
        from .train import HypTuning
        hyp_tuning = HypTuning(joints=args.joints, epochs=args.epochs,
                               monocular=args.monocular, dropout=args.dropout,
                               multiplier=args.multiplier, r_seed=args.r_seed)
        return hyp_tuning.train(args)
    shape = mesh_shape(args)
    if shape is None:
        return _train_worker(None, args)
    from .parallel import launch
    return launch(_train_worker, *shape, args=(args,), device_type=_device_type(args))


def main(argv=None):
    """Parse argv (sys.argv when None) and run; returns predict's engine
    (None under --mode keypoints; --webcam: the engine and the frame
    count), prep's preprocessor, train's Trainer (--hyp: the best trial's
    dict), or eval's result (`evaluate`)."""
    args = cli(argv)
    if args.command == 'predict':
        if args.webcam:
            from .visuals.webcam import webcam
            try:
                return webcam(args)
            except ImportError as exc:
                raise SystemExit(f"predict --webcam: {exc}") from None
        from .predict import predict
        return predict(args)
    if args.command == 'prep':
        return prep(args)
    if args.command == 'train':
        return train(args)
    if args.command == 'eval':
        return evaluate(args)
    raise SystemExit("no command given: python -m monoloco_tpu_torch.run "
                     "predict|prep|train|eval ...")


if __name__ == '__main__':
    main()
