"""CLI entry point: python -m monoloco_tpu_torch.run predict ...

The predict flags of `monoloco_tpu.run` that the torch port honours. `prep`,
`train` and `eval` are not ported yet: they exit non-zero with a message
(use `python -m monoloco_tpu.run` for them).
"""

import argparse


def cli(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    subparsers = parser.add_subparsers(help='Different parsers for main actions',
                                       dest='command')
    predict_parser = subparsers.add_parser("predict")
    for name in ('prep', 'train', 'eval'):
        sub = subparsers.add_parser(name, help='not ported yet')
        sub.add_argument('rest', nargs=argparse.REMAINDER)

    predict_parser.add_argument('images', nargs='*', help='input images')
    predict_parser.add_argument('--glob', help='glob expression for input images')
    predict_parser.add_argument('--json_dir', help='directory of precomputed pifpaf json files')
    predict_parser.add_argument('-o', '--output-directory', dest='output_directory',
                                help='Output directory')
    predict_parser.add_argument('--output_types', nargs='+', default=['json'],
                                help='what to output: json (figures are not ported)')
    predict_parser.add_argument('--json-output', default=None, nargs='?', const=True,
                                help='whether to output a pifpaf json file')
    predict_parser.add_argument('--disable-cuda', dest='disable_cuda', action='store_true',
                                help='run on the CPU; without it predict needs a CUDA card')
    predict_parser.add_argument('--activities', nargs='+',
                                choices=['raise_hand', 'social_distance'], default=[],
                                help='activities to show (not ported)')
    predict_parser.add_argument('--mode', help='mono or stereo (keypoints: not ported)',
                                default='mono')
    predict_parser.add_argument('--model', help='path of MonoLoco/MonStereo model to load')
    predict_parser.add_argument('--net', help='only to select older MonoLoco models')
    predict_parser.add_argument('--path_gt', help='path of json file with gt 3d localization')
    predict_parser.add_argument('--n_dropout', type=int, default=0,
                                help='Epistemic uncertainty evaluation (not ported)')
    predict_parser.add_argument('--dropout', type=float, default=0.2, help='dropout parameter')
    predict_parser.add_argument('--webcam', help='webcam streaming (not ported)',
                                action='store_true')
    predict_parser.add_argument('--calibration', type=str, default='custom',
                                help='camera calibration: custom, nuscenes, or kitti')
    predict_parser.add_argument('--focal_length', type=float, default=5.7,
                                help='focal length in mm for a sensor of 7.2x5.4 mm')
    return parser.parse_args(argv)


def main(argv=None):
    """Parse argv (sys.argv when None) and run; returns predict's engine."""
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
