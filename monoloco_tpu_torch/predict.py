"""Prediction: images + pifpaf poses -> `.monoloco.json` and figures.

Counterpart of `monoloco_tpu/predict.py` for `--mode mono`, `--mode stereo`
and `--mode keypoints`. Per image (per left/right pair in stereo): load the
pifpaf annotations, build the calibration, forward the localization net
(with `--n_dropout`, the MC-dropout epistemic passes too), post-process
(optionally against ground truth), apply `--activities`, and write
`out_<name>.monoloco.json` and/or the `front`, `bird` and `multi` figures
(the left image's name in stereo). More than two images (pairs) forward in
64-image (64-pair) chunks, one dispatch each (two with MC dropout), two
deep: the device computes one chunk while the host writes the previous one.
`--mode keypoints` builds no net: it draws the poses (`.keypoints.png`) or
writes an empty JSON, per image.

Stereo takes the images sorted, an even number of them, as consecutive
(left, right) pairs, as the JAX package does.

The image size comes from the PNG or JPEG header (stdlib). matplotlib and
Pillow are imported only when a figure is drawn: a json-only run needs
neither, and a run that asks for a figure without them exits before any net
is built. `--profile DIR` writes a torch.profiler Chrome trace of the run
into DIR.

The poses of an image come from a pifpaf JSON beside it (`<image>.pifpaf.json`,
`<image>.predictions.json`) or in `--json_dir`; without one, OpenPifPaf runs
on the image when it is installed (`run_pifpaf`: one Predictor per
`--checkpoint`, its decoder flags forwarded through OpenPifPaf's own
`configure` hooks, its net on the card unless `--disable-cuda`), and
without either the run stops naming the image. `--webcam` runs in
`visuals/webcam.py`.
"""

import glob
import importlib
import json
import logging
import os
import struct
import time
from collections import defaultdict

import numpy as np
import torch

from .network import Loco, factory_for_gt, load_calibration, preprocess_pifpaf
from .ops import launches

LOG = logging.getLogger(__name__)

CHUNK = 64
FIGURE_TYPES = ('front', 'bird', 'multi')


def image_size(path):
    """(width, height) of a PNG or JPEG image, read from its header."""
    with open(path, 'rb') as f:
        head = f.read(24)
        if head[:8] == b'\x89PNG\r\n\x1a\n' and head[12:16] == b'IHDR':
            return struct.unpack('>II', head[16:24])
        if head[:2] == b'\xff\xd8':
            f.seek(2)
            while True:
                byte = f.read(1)
                while byte and byte != b'\xff':
                    byte = f.read(1)
                while byte == b'\xff':
                    byte = f.read(1)
                if not byte:
                    break
                marker = byte[0]
                if marker == 0x01 or 0xd0 <= marker <= 0xd8:
                    continue                      # markers without a length
                (length,) = struct.unpack('>H', f.read(2))
                if 0xc0 <= marker <= 0xcf and marker not in (0xc4, 0xc8, 0xcc):
                    _bits, height, width = struct.unpack('>BHH', f.read(5))
                    return width, height
                f.seek(length - 2, 1)
    raise ValueError(f"{path}: no PNG or JPEG size header found")


def find_pifpaf_json(image_path, json_dir=None):
    """Locate a precomputed pifpaf predictions file for an image."""
    base = os.path.basename(image_path)
    stem = os.path.splitext(base)[0]
    candidates = []
    if json_dir:
        candidates += [
            os.path.join(json_dir, base + '.pifpaf.json'),
            os.path.join(json_dir, base + '.predictions.json'),
            os.path.join(json_dir, stem + '.pifpaf.json'),
            os.path.join(json_dir, stem + '.json'),
        ]
    candidates += [
        image_path + '.pifpaf.json',
        image_path + '.predictions.json',
        os.path.splitext(image_path)[0] + '.pifpaf.json',
    ]
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return None


def _pifpaf_available():
    try:
        import openpifpaf  # noqa: F401
        return True
    except ImportError:
        return False


_PIFPAF_PREDICTOR = {}


def run_pifpaf(image_paths, checkpoint=None, batch_size=1, args=None):
    """Run OpenPifPaf on images; yields (path, annotations_json) per image.

    The Predictor (a full CNN checkpoint load) is made once per checkpoint.
    With `args`, `force_complete_pose` defaults to true (the net needs all
    17 keypoints), `device` to the card unless `disable_cuda`, and the
    namespace goes to `openpifpaf.decoder.configure` and
    `openpifpaf.Predictor.configure`; a hook that fails on a partial
    namespace is skipped with a warning, as in the JAX package."""
    import openpifpaf
    if args is not None:
        if not hasattr(args, 'force_complete_pose'):
            args.force_complete_pose = True
        if not hasattr(args, 'device'):
            on_card = torch.cuda.is_available() and not getattr(args, 'disable_cuda', False)
            args.device = torch.device('cuda' if on_card else 'cpu')
        for mod in (getattr(openpifpaf, 'decoder', None),
                    getattr(openpifpaf, 'Predictor', None)):
            try:
                mod.configure(args)
            except Exception as exc:  # partial args namespace
                LOG.warning("openpifpaf %s.configure skipped (%s) — decoder flags may not "
                            "take effect", getattr(mod, '__name__', mod), exc)
    if checkpoint not in _PIFPAF_PREDICTOR:
        _PIFPAF_PREDICTOR[checkpoint] = openpifpaf.Predictor(checkpoint=checkpoint)
    predictor = _PIFPAF_PREDICTOR[checkpoint]
    for pred, _, meta in predictor.images(image_paths, batch_size=batch_size):
        yield meta['file_name'], [ann.json_data() for ann in pred]


def load_annotations(image_path, args):
    """The pifpaf annotations of an image: its JSON, else OpenPifPaf's."""
    path = find_pifpaf_json(image_path, getattr(args, 'json_dir', None))
    if path is not None:
        with open(path) as f:
            anns = json.load(f)
        # the loose '<stem>.json' candidate can hit an unrelated file
        if not isinstance(anns, list) or any(
                not isinstance(a, dict) or 'keypoints' not in a for a in anns):
            raise ValueError(f"{path} does not look like pifpaf predictions "
                             "(expected a list of annotation dicts with 'keypoints')")
        return anns
    if _pifpaf_available():
        for _, anns in run_pifpaf([image_path], checkpoint=getattr(args, 'checkpoint', None),
                                  args=args):
            return anns
    raise FileNotFoundError(
        f"No pifpaf annotations for {image_path}: provide <image>.pifpaf.json "
        f"(or --json_dir), or install openpifpaf")


def draws_figures(args):
    """Whether the run draws a figure: `--mode keypoints` unless the outputs
    are json alone, else a front, bird or multi output."""
    if args.output_types == ['json']:
        return False
    return args.mode == 'keypoints' or any(t in args.output_types for t in FIGURE_TYPES)


def _require_figure_packages():
    """Exit naming matplotlib or Pillow when one of them is missing."""
    for module, package in (('matplotlib', 'matplotlib'), ('PIL', 'Pillow')):
        try:
            importlib.import_module(module)
        except ImportError:
            raise SystemExit(f"the figure outputs need {package}, which is not installed "
                             f"here: pass --output_types json, or install {package}") from None


def factory_from_args(args):
    if args.glob:
        args.images += sorted(glob.glob(args.glob))
    if not args.images:
        raise SystemExit("no image files given")
    if args.mode not in ('keypoints', 'mono', 'stereo'):
        raise SystemExit(f"predict --mode {args.mode}: use keypoints, mono or stereo")
    if args.path_gt is None:
        args.show_all = True
    if not args.output_types and args.mode != 'keypoints':
        # Activity rendering draws front/bird views (show_activities).
        args.output_types = ['front', 'bird'] if args.activities else ['multi']
    if args.activities and not any(x in args.output_types for x in ('front', 'bird', 'json')):
        raise SystemExit("--activities outputs render as front/bird views (or json): pass "
                         "--output_types front bird [json]")
    if args.mode == 'stereo':
        args.images = sorted(args.images)
        if len(args.images) % 2:
            raise SystemExit(f"Odd number of images in a stereo setting ({len(args.images)}): "
                             "stereo takes (left, right) pairs")
        if 'social_distance' in args.activities:
            raise SystemExit("Social distance not supported in stereo modality")
    if 'social_distance' in args.activities and args.net == 'monoloco':
        # the legacy net predicts no orientation, and F-formations need yaw
        raise SystemExit("social_distance requires orientation output: the legacy monoloco "
                         "net does not predict yaw — use monoloco_pp")
    if args.mode != 'keypoints':
        if not any(x in args.output_types for x in FIGURE_TYPES + ('json',)):
            raise SystemExit("No output type specified, please select one among front, bird, "
                             "multi, json")
        if not args.model:
            raise SystemExit("--model checkpoint path required")
    if draws_figures(args):
        _require_figure_packages()
    return args


def predict(args):
    """Run prediction; returns the Loco engine, whose dispatch counters say
    which MLP path the run took (None under --mode keypoints). With
    args.profile, the run is traced by torch.profiler (CUDA activity too
    when it runs on a card) into <profile>/predict_trace.json."""
    args = factory_from_args(args)
    if not getattr(args, 'profile', None):
        return _predict_run(args)
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available() and not args.disable_cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        net = _predict_run(args)
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(args.profile, 'predict_trace.json')
    prof.export_chrome_trace(path)
    print(f"torch.profiler trace: {path}")
    return net


def _predict_run(args):
    net = None
    if args.mode in ('mono', 'stereo'):
        device = 'cpu' if args.disable_cuda else None
        net = Loco(model=args.model, mode=args.mode, net=args.net, device=device,
                   n_dropout=args.n_dropout, p_dropout=args.dropout)
    if args.output_directory is not None:
        os.makedirs(args.output_directory, exist_ok=True)
    step = 2 if args.mode == 'stereo' else 1
    if (net is not None and len(args.images) // step > 2
            and net.net in ('monoloco_pp', 'monoloco_p', 'monstereo')):
        _predict_batched(args, net, step)
    else:
        _predict_per_image(args, net, step)
    if net is not None:
        print(f"Dispatches: {net.n_dispatches}, through the dyn8 route: "
              f"{net.n_dispatches_int8}, kernel launches: {dict(launches)} "
              f"(precision {net.precision}, device {net.device})")
    return net


def _load_one(args, image_path, right_path=None):
    """Annotations, boxes, keypoints, calibration and ground truth of one
    image, and the keypoints of its right image (None without one)."""
    annotations = load_annotations(image_path, args)
    if args.json_output is not None:
        _dump_pifpaf_json(args, image_path, annotations)
    w, h = image_size(image_path)
    im_size = (float(w), float(h))
    if args.path_gt is not None:
        dic_gt, kk = factory_for_gt(args.path_gt, os.path.basename(image_path))
    else:
        kk = load_calibration(args.calibration, im_size, focal_length=args.focal_length)
        dic_gt = None
    boxes, keypoints = preprocess_pifpaf(annotations, im_size, enlarge_boxes=False)
    keypoints_r = None
    if right_path is not None:
        _, keypoints_r = preprocess_pifpaf(load_annotations(right_path, args), im_size)
    return annotations, boxes, keypoints, keypoints_r, kk, dic_gt


def _pairs(args, step):
    """(image, its right image or None) for each forward: consecutive pairs
    in stereo (step 2), each image alone in mono."""
    return [(args.images[i], args.images[i + 1] if step == 2 else None)
            for i in range(0, len(args.images), step)]


def _activities(args, net, dic_out, keypoints):
    """The --activities flags, after post-processing."""
    if 'social_distance' in args.activities:
        dic_out = net.social_distance(dic_out, args)
    if 'raise_hand' in args.activities:
        dic_out = net.raising_hand(dic_out, keypoints)
    return dic_out


def _predict_per_image(args, net, step):
    timing = []
    for cnt, (image_path, right_path) in enumerate(_pairs(args, step)):
        output_path = _output_path(args, image_path)
        if args.mode == 'keypoints':
            annotations = load_annotations(image_path, args)
            if args.json_output is not None:
                _dump_pifpaf_json(args, image_path, annotations)
            print(f'{cnt} image {os.path.basename(image_path)} saved as {output_path}')
            factory_outputs(args, image_path, annotations, defaultdict(list), output_path)
            print(f'Image {cnt}\n' + '-' * 120)
            continue
        annotations, boxes, keypoints, keypoints_r, kk, dic_gt = _load_one(
            args, image_path, right_path)
        print(f'{cnt} image {os.path.basename(image_path)} saved as {output_path}')
        start = time.time()
        dic_out = net.forward(keypoints, kk, keypoints_r=keypoints_r)
        fwd_time = (time.time() - start) * 1000
        timing.append(fwd_time)
        print(f"Forward time: {fwd_time:.0f} ms")
        dic_out = net.post_process(dic_out, boxes, keypoints, kk, dic_gt)
        dic_out = _activities(args, net, dic_out, keypoints)
        factory_outputs(args, image_path, annotations, dic_out, output_path, kk=kk)
        print(f'Image {cnt}\n' + '-' * 120)
    if timing:
        timing_arr = np.array(timing)
        print(f'Processed {len(timing) * step} images with an average time of '
              f'{int(timing_arr.mean())} ms and a std of {int(timing_arr.std())} ms')


def _predict_batched(args, net, step):
    """Forward 64-image (stereo: 64-pair) chunks as one dispatch each (with
    MC dropout, two), two deep: chunk s loads and launches while chunk s-1
    is still on the device. Post-processing, activities and outputs are per
    image, as in the per-image loop."""
    pairs = _pairs(args, step)
    cnt = 0
    since = time.time()

    def launch(s):
        batch = [(p, *_load_one(args, p, r)) for p, r in pairs[s:s + CHUNK]]
        fin = net.forward_batch_async([b[3] for b in batch], [b[5] for b in batch],
                                      [b[4] for b in batch])
        return batch, fin

    def drain(batch, fin):
        nonlocal cnt
        for (image_path, annotations, boxes, keypoints, _, kk, dic_gt), dic_fwd in zip(
                batch, fin()):
            output_path = _output_path(args, image_path)
            dic_out = net.post_process(dic_fwd, boxes, keypoints, kk, dic_gt)
            dic_out = _activities(args, net, dic_out, keypoints)
            factory_outputs(args, image_path, annotations, dic_out, output_path, kk=kk)
            print(f'{cnt} image {os.path.basename(image_path)} saved as {output_path}')
            cnt += 1

    pending = None
    for s in range(0, len(pairs), CHUNK):
        launched = launch(s)
        if pending is not None:
            drain(*pending)
        pending = launched
    if pending is not None:
        drain(*pending)
    wall = time.time() - since
    print(f'Processed {cnt * step} images in {wall:.2f} s '
          f'({cnt * step / max(wall, 1e-9):.1f} images/s, batched forward)')


def _open_rgb(image_path):
    from PIL import Image
    with open(image_path, 'rb') as f:
        return Image.open(f).convert('RGB')


def factory_outputs(args, image_path, annotations, dic_out, output_path, kk=None):
    """Write the JSON and/or draw the figures of one image; the image is read
    with Pillow only for a figure."""
    if 'json' in args.output_types:
        _write_json(dic_out, output_path)
        if len(args.output_types) == 1:
            return

    if args.mode == 'keypoints':
        from .visuals.pifpaf_show import KeypointPainter, get_pifpaf_outputs, image_canvas
        kps, _ = get_pifpaf_outputs(annotations)
        with image_canvas(_open_rgb(image_path), output_path + '.keypoints.png') as ax:
            KeypointPainter().keypoints(ax, kps)
        return

    if any(x in args.output_types for x in FIGURE_TYPES):
        cpu_image = _open_rgb(image_path)
        if args.activities:
            from .activity import show_activities
            show_activities(args, cpu_image, output_path, annotations, dic_out)
        else:
            from .visuals.printer import Printer
            printer = Printer(cpu_image, output_path, kk, args)
            figures, axes = printer.factory_axes(dic_out)
            printer.draw(figures, axes, cpu_image, dic_out, annotations=annotations)


def _output_path(args, image_path):
    if args.output_directory is None:
        splits = os.path.split(image_path)
        return os.path.join(splits[0], 'out_' + splits[1])
    return os.path.join(args.output_directory, 'out_' + os.path.basename(image_path))


def _dump_pifpaf_json(args, image_path, annotations):
    json_dir = args.json_output if isinstance(args.json_output, str) \
        else (args.output_directory or os.path.dirname(image_path))
    if json_dir:
        os.makedirs(json_dir, exist_ok=True)
    json_out = os.path.join(json_dir, os.path.basename(image_path) + '.predictions.json')
    with open(json_out, 'w') as f:
        json.dump(annotations, f)


def _write_json(dic_out, output_path):
    with open(output_path + '.monoloco.json', 'w') as ff:
        json.dump(_jsonable(dic_out), ff)


def _jsonable(obj):
    """Recursively convert numpy types for json.dump."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj
