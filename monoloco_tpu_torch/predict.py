"""Prediction: images + precomputed pifpaf poses -> `.monoloco.json`.

Counterpart of `monoloco_tpu/predict.py` for `--mode mono` and `--mode
stereo` with `--output_types json`. Per image (per left/right pair in
stereo): load the pifpaf annotations, build the calibration, forward the
localization net, post-process (optionally against ground truth), write
`out_<name>.monoloco.json` (the left image's name in stereo). More than two
images (pairs) forward in 64-image (64-pair) chunks, one dispatch each, two
deep: the device computes one chunk while the host writes the previous one.

Stereo takes the images sorted, an even number of them, as consecutive
(left, right) pairs, as the JAX package does.

The image size comes from the PNG or JPEG header (stdlib), so Pillow is not
needed. Figures, `--activities`, `--webcam`, `--mode keypoints`, MC dropout
and running OpenPifPaf itself are not ported yet and are refused with a
message.
"""

import glob
import json
import os
import struct
import time

import numpy as np

from .network import Loco, factory_for_gt, load_calibration, preprocess_pifpaf
from .ops import launches

CHUNK = 64


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


def load_annotations(image_path, args):
    path = find_pifpaf_json(image_path, getattr(args, 'json_dir', None))
    if path is None:
        raise FileNotFoundError(
            f"No pifpaf annotations for {image_path}: provide <image>.pifpaf.json "
            f"(or --json_dir); running OpenPifPaf is not ported to the torch "
            f"package yet")
    with open(path) as f:
        anns = json.load(f)
    # the loose '<stem>.json' candidate can hit an unrelated file
    if not isinstance(anns, list) or any(
            not isinstance(a, dict) or 'keypoints' not in a for a in anns):
        raise ValueError(f"{path} does not look like pifpaf predictions "
                         "(expected a list of annotation dicts with 'keypoints')")
    return anns


def factory_from_args(args):
    if args.glob:
        args.images += sorted(glob.glob(args.glob))
    if not args.images:
        raise SystemExit("no image files given")
    if args.mode not in ('mono', 'stereo'):
        raise SystemExit(f"predict --mode {args.mode} is not ported to the torch "
                         "package yet (ROADMAP Queue 1 item 2): use --mode mono or stereo")
    if args.mode == 'stereo':
        args.images = sorted(args.images)
        if len(args.images) % 2:
            raise SystemExit(f"Odd number of images in a stereo setting ({len(args.images)}): "
                             "stereo takes (left, right) pairs")
    if args.activities:
        raise SystemExit("predict --activities is not ported to the torch package yet "
                         "(ROADMAP Queue 1 item 2)")
    if args.n_dropout > 0:
        raise SystemExit("predict --n_dropout (MC dropout) is not ported to the torch "
                         "package yet (ROADMAP Queue 1 item 1)")
    if args.output_types != ['json']:
        raise SystemExit("the torch package writes --output_types json only; "
                         "figure outputs are not ported yet")
    if not args.model:
        raise SystemExit("--model checkpoint path required")
    return args


def predict(args):
    """Run prediction; returns the Loco engine, whose dispatch counters say
    which MLP path the run took."""
    args = factory_from_args(args)
    device = 'cpu' if args.disable_cuda else None
    net = Loco(model=args.model, mode=args.mode, net=args.net, device=device,
               n_dropout=args.n_dropout, p_dropout=args.dropout)
    if args.output_directory is not None:
        os.makedirs(args.output_directory, exist_ok=True)
    step = 2 if args.mode == 'stereo' else 1
    if len(args.images) // step > 2 and net.net in ('monoloco_pp', 'monoloco_p', 'monstereo'):
        _predict_batched(args, net, step)
    else:
        _predict_per_image(args, net, step)
    print(f"Dispatches: {net.n_dispatches}, through the dyn8 route: "
          f"{net.n_dispatches_int8}, kernel launches: {dict(launches)} "
          f"(precision {net.precision}, device {net.device})")
    return net


def _load_one(args, image_path, right_path=None):
    """Boxes, keypoints, calibration and ground truth of one image, and the
    keypoints of its right image (None without one)."""
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
    return boxes, keypoints, keypoints_r, kk, dic_gt


def _pairs(args, step):
    """(image, its right image or None) for each forward: consecutive pairs
    in stereo (step 2), each image alone in mono."""
    return [(args.images[i], args.images[i + 1] if step == 2 else None)
            for i in range(0, len(args.images), step)]


def _predict_per_image(args, net, step):
    timing = []
    for cnt, (image_path, right_path) in enumerate(_pairs(args, step)):
        boxes, keypoints, keypoints_r, kk, dic_gt = _load_one(args, image_path, right_path)
        output_path = _output_path(args, image_path)
        print(f'{cnt} image {os.path.basename(image_path)} saved as {output_path}')
        start = time.time()
        dic_out = net.forward(keypoints, kk, keypoints_r=keypoints_r)
        fwd_time = (time.time() - start) * 1000
        timing.append(fwd_time)
        print(f"Forward time: {fwd_time:.0f} ms")
        dic_out = net.post_process(dic_out, boxes, keypoints, kk, dic_gt)
        _write_json(dic_out, output_path)
        print(f'Image {cnt}\n' + '-' * 120)
    timing_arr = np.array(timing)
    print(f'Processed {len(timing) * step} images with an average time of '
          f'{int(timing_arr.mean())} ms and a std of {int(timing_arr.std())} ms')


def _predict_batched(args, net, step):
    """Forward 64-image (stereo: 64-pair) chunks as one dispatch each, two
    deep: chunk s loads and launches while chunk s-1 is still on the device."""
    pairs = _pairs(args, step)
    cnt = 0
    since = time.time()

    def launch(s):
        batch = [(p, *_load_one(args, p, r)) for p, r in pairs[s:s + CHUNK]]
        fin = net.forward_batch_async([b[2] for b in batch], [b[4] for b in batch],
                                      [b[3] for b in batch])
        return batch, fin

    def drain(batch, fin):
        nonlocal cnt
        for (image_path, boxes, keypoints, _, kk, dic_gt), dic_fwd in zip(batch, fin()):
            output_path = _output_path(args, image_path)
            dic_out = net.post_process(dic_fwd, boxes, keypoints, kk, dic_gt)
            _write_json(dic_out, output_path)
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
