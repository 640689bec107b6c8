"""CLI entry point: python -m monoloco_tpu_torch.run predict ...

The predict flags of `monoloco_tpu.run`, so that a JAX predict command line
runs on the port unchanged. The pifpaf passthroughs (`--checkpoint`,
`--long-edge`, `--white-overlay`, `--font-size`, `--monocolor-connections`,
`--instance-threshold`, `--seed-threshold`, `--precise-rescaling`,
`--decoder-workers`) and `--camera` are accepted and inert: the port reads
precomputed pifpaf JSON and does not run OpenPifPaf. `--webcam` exits
non-zero with a message, as do `prep`, `train` and `eval`, which are not
ported yet (use `python -m monoloco_tpu.run` for them).
"""

import argparse


def _camera_source(value):
    """A device index, or a video file path."""
    return int(value) if value.lstrip('-').isdigit() else value


def cli(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    subparsers = parser.add_subparsers(help='Different parsers for main actions',
                                       dest='command')
    predict_parser = subparsers.add_parser("predict")
    for name in ('prep', 'train', 'eval'):
        sub = subparsers.add_parser(name, help='not ported yet')
        sub.add_argument('rest', nargs=argparse.REMAINDER)

    add = predict_parser.add_argument
    add('images', nargs='*', help='input images')
    add('--glob', help='glob expression for input images')
    add('--checkpoint', help='pifpaf model (inert: OpenPifPaf is not run)')
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
    add('--webcam', help='webcam streaming (not ported)', action='store_true')
    add('--camera', help='webcam device index, or a video file path (inert)',
        type=_camera_source, default=0)
    add('--profile', help='directory for a torch.profiler trace of the run')
    add('--calibration', type=str, default='custom',
        help='camera calibration: custom, nuscenes, or kitti')
    add('--focal_length', type=float, default=5.7,
        help='focal length in mm for a sensor of 7.2x5.4 mm')
    add('--threshold_prob', type=float, default=0.25, help='concordance for samples')
    add('--threshold_dist', type=float, default=2.5, help='min distance of people')
    add('--radii', nargs='+', type=float, default=(0.3, 0.5, 1), help='o-space radii')
    return parser.parse_args(argv)


def main(argv=None):
    """Parse argv (sys.argv when None) and run; returns predict's engine
    (None under --mode keypoints)."""
    args = cli(argv)
    if args.command == 'predict':
        if args.webcam:
            raise SystemExit("predict --webcam is not ported to the torch package yet")
        from .predict import predict
        return predict(args)
    if args.command in ('prep', 'train', 'eval'):
        raise SystemExit(f"'{args.command}' is not ported to monoloco_tpu_torch yet "
                         f"(ROADMAP Queue 1): run python -m monoloco_tpu.run "
                         f"{args.command}")
    raise SystemExit("no command given: python -m monoloco_tpu_torch.run predict ...")


if __name__ == '__main__':
    main()
