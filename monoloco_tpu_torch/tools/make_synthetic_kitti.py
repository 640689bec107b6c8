"""Generate a synthetic mini-KITTI dataset: a copy of the JAX package's
`tools/make_synthetic_kitti.py` that runs without Pillow.

Creates, under a root directory, the layout the KITTI pipelines expect:
  data/kitti/gt/<id>.txt         ground-truth (Pedestrian rows)
  data/kitti/calib/<id>.txt      P0..P3 projection matrices (stereo rig)
  data/kitti/images/<id>.png     1242 x 375 RGB images (easy mode: person
                                 textures, right camera in images_r/; hard
                                 mode: flat gray)
  annotations/<id>.png.predictions.json        left pifpaf predictions
  annotations_right/<id>.png.predictions.json  right pifpaf predictions
  splits/kitti_train.txt, splits/kitti_val.txt

Pedestrians are placed at known (x, z); COCO-17 keypoints are produced by
projecting a canonical skeleton through K, and right-camera keypoints are the
left ones shifted by the stereo disparity B*f/z. `hard=True` gives the
adversarial variant: crowds, occlusion, truncation, height variation, missed
and hallucinated detections (see the JAX tool's docstring).

For a seed, the gt, calib and both annotation trees are byte for byte the
JAX tool's, and its images pixel for pixel. PNGs are written by a stdlib
(zlib) encoder; `images=False` writes none, and still draws the texture
noise of every easy-mode person, so the random stream, and with it every
other file, stays the same. GenerateKitti and EvalKitti read no image.

Usage: python -m monoloco_tpu_torch.tools.make_synthetic_kitti ROOT
           [--n_train N] [--n_val N] [--seed S] [--hard] [--no-images]
"""

import argparse
import functools
import json
import math
import os
import struct
import zlib

import numpy as np

FX = FY = 721.5377
CX, CY = 609.5593, 172.854
BASELINE = 0.54
IM_W, IM_H = 1242, 375

# Canonical skeleton: per-joint (dy from top of head [m], dx from center [m])
# in a 1.77m-tall person's body frame. COCO order.
_SKELETON = [
    (0.07, 0.00),   # nose
    (0.05, -0.03), (0.05, 0.03),     # eyes
    (0.08, -0.07), (0.08, 0.07),     # ears
    (0.25, -0.18), (0.25, 0.18),     # shoulders
    (0.50, -0.22), (0.50, 0.22),     # elbows
    (0.72, -0.24), (0.72, 0.24),     # wrists
    (0.80, -0.10), (0.80, 0.10),     # hips
    (1.20, -0.11), (1.20, 0.11),     # knees
    (1.65, -0.12), (1.65, 0.12),     # ankles
]
PERSON_H = 1.77
GRAY = 90


def write_png(path, rgb):
    """Write an (h, w, 3) uint8 array as an 8-bit RGB PNG (filter 0 rows)."""
    with open(path, 'wb') as f:
        f.write(encode_png(rgb))


@functools.lru_cache(maxsize=1)
def _flat_gray_png():
    """The encoded flat gray image of every hard-mode scene, made once."""
    return encode_png(np.full((IM_H, IM_W, 3), GRAY, np.uint8))


def encode_png(rgb):
    """The bytes of an (h, w, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + chunk(b'IEND', b''))


def _project(x, y, z):
    return FX * x / z + CX, FY * y / z + CY


def make_person(x, z, rng, cam_shift=0.0):
    """COCO keypoints + box for a person whose head top is at y=-0.8 (camera
    1m above ground-ish). Returns (kps_flat_51, bbox_xywh, gt_fields)."""
    y_top = -0.65
    xs, ys = [], []
    for dy, dx in _SKELETON:
        u, v = _project(x - cam_shift + dx, y_top + dy, z)
        xs.append(u + rng.randn() * 0.3)
        ys.append(v + rng.randn() * 0.3)
    confs = [0.85 + 0.1 * rng.rand() for _ in range(17)]
    flat = []
    for u, v, c in zip(xs, ys, confs):
        flat += [round(u, 2), round(v, 2), round(c, 3)]
    x1, y1 = min(xs) - 3, min(ys) - 5
    x2, y2 = max(xs) + 3, max(ys) + 5
    bbox = [x1, y1, x2 - x1, y2 - y1]
    # gt box slightly tighter
    gt_box = [min(xs) - 1, min(ys) - 3, max(xs) + 1, max(ys) + 3]
    y_center = y_top + PERSON_H / 2
    return flat, bbox, dict(box=gt_box, xyz=(x, y_center + 0.85, z))


def identity_texture(identity, h, w, noise_rng=None):
    """Deterministic per-identity appearance: a base color + striped clothing
    pattern, the visual signature a ReID embedding can learn. The SAME
    identity renders the same texture in the left and right camera (up to
    sensor noise), which is exactly the stereo-association signal
    (the ReID baseline crops)."""
    id_rng = np.random.RandomState(identity * 7919 + 13)
    base = id_rng.randint(40, 220, size=3)
    stripe = id_rng.randint(40, 220, size=3)
    period = id_rng.randint(6, 20)
    phase = id_rng.randint(0, period)
    vertical = id_rng.rand() < 0.5
    h, w = max(int(h), 1), max(int(w), 1)
    yy, xx = np.mgrid[0:h, 0:w]
    coord = xx if vertical else yy
    mask = ((coord + phase) // (period // 2 + 1)) % 2 == 0
    tex = np.where(mask[:, :, None], base[None, None, :], stripe[None, None, :])
    tex = tex.astype(np.float32)
    if noise_rng is not None:
        tex += noise_rng.randn(h, w, 3) * 6.0
    return np.clip(tex, 0, 255).astype(np.uint8)


def _render_scene_image(persons, rng, draw=True):
    """persons: list of (box_xyxy, identity, z); drawn far-to-near so closer
    people occlude. Returns an (IM_H, IM_W, 3) uint8 array; with draw=False
    only the texture noise is drawn from rng, the same draws, and None is
    returned."""
    canvas = np.full((IM_H, IM_W, 3), GRAY, np.uint8) if draw else None
    for box, identity, _z in sorted(persons, key=lambda p: -p[2]):
        x1 = int(max(0, min(IM_W - 1, box[0])))
        y1 = int(max(0, min(IM_H - 1, box[1])))
        x2 = int(max(0, min(IM_W, box[2])))
        y2 = int(max(0, min(IM_H, box[3])))
        if x2 - x1 < 1 or y2 - y1 < 1:
            continue
        if draw:
            canvas[y1:y2, x1:x2] = identity_texture(identity, y2 - y1, x2 - x1,
                                                    noise_rng=rng)
        else:
            rng.randn(y2 - y1, x2 - x1, 3)
    return canvas


def _write_files(root, name, gt_lines, anns_l, anns_r,
                 persons_l=None, persons_r=None, rng=None, images=True):
    """Write one scene's gt txt, calibration, image(s), and both pifpaf jsons.

    With persons_l/persons_r (lists of (box, identity, z)), the left AND
    right camera images render identity-consistent person textures (and the
    right image lands in data/kitti/images_r, where GenerateKitti's ReID
    baseline crops from); otherwise the left image is flat gray. With
    images=False no image is written, and the textures' noise is still drawn."""
    gt_dir = os.path.join(root, 'data', 'kitti', 'gt')
    calib_dir = os.path.join(root, 'data', 'kitti', 'calib')
    im_dir = os.path.join(root, 'data', 'kitti', 'images')
    ann_dir = os.path.join(root, 'annotations')
    ann_dir_r = os.path.join(root, 'annotations_right')
    for d in (gt_dir, calib_dir, ann_dir, ann_dir_r) + ((im_dir,) if images else ()):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(gt_dir, name + '.txt'), 'w') as f:
        f.writelines(gt_lines)
    p2 = (f"P2: {FX} 0 {CX} 0 0 {FY} {CY} 0 0 0 1 0\n")
    p3 = (f"P3: {FX} 0 {CX} {-FX * BASELINE} 0 {FY} {CY} 0 0 0 1 0\n")
    with open(os.path.join(calib_dir, name + '.txt'), 'w') as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nP1: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        f.write(p2)
        f.write(p3)
    if persons_l is not None:
        left = _render_scene_image(persons_l, rng, draw=images)
        right = _render_scene_image(persons_r, rng, draw=images)
        if images:
            write_png(os.path.join(im_dir, name + '.png'), left)
            im_dir_r = os.path.join(root, 'data', 'kitti', 'images_r')
            os.makedirs(im_dir_r, exist_ok=True)
            write_png(os.path.join(im_dir_r, name + '.png'), right)
    elif images:
        with open(os.path.join(im_dir, name + '.png'), 'wb') as f:
            f.write(_flat_gray_png())
    with open(os.path.join(ann_dir, name + '.png.predictions.json'), 'w') as f:
        json.dump(anns_l, f)
    with open(os.path.join(ann_dir_r, name + '.png.predictions.json'), 'w') as f:
        json.dump(anns_r, f)


def write_scene(root, idx, people, rng, images=True):
    """people: list of (x, z, ry)."""
    name = str(idx).zfill(6)
    gt_lines, anns_l, anns_r = [], [], []
    persons_l, persons_r = [], []
    for pi, (x, z, ry) in enumerate(people):
        flat_l, bbox_l, gt = make_person(x, z, rng, cam_shift=0.0)
        flat_r, bbox_r, _ = make_person(x, z, rng, cam_shift=BASELINE)
        # Identity-consistent L/R appearance for the ReID baseline: unique
        # per (scene, person), identical texture in both cameras.
        identity = idx * 100 + pi
        to_xyxy = lambda b: [b[0], b[1], b[0] + b[2], b[1] + b[3]]
        persons_l.append((to_xyxy(bbox_l), identity, z))
        persons_r.append((to_xyxy(bbox_r), identity, z))
        gx, gy, gz = gt['xyz']
        alpha = ry - math.atan2(gx, gz)
        if alpha > math.pi:
            alpha -= 2 * math.pi
        elif alpha < -math.pi:
            alpha += 2 * math.pi
        b = gt['box']
        gt_lines.append(
            f"Pedestrian 0.00 0 {alpha:.2f} "
            f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"1.77 0.65 0.80 {gx:.2f} {gy:.2f} {gz:.2f} {ry:.2f}\n")
        anns_l.append({'keypoints': flat_l, 'bbox': [round(v, 2) for v in bbox_l],
                       'score': round(0.7 + 0.25 * rng.rand(), 3),
                       'category_id': 1})
        anns_r.append({'keypoints': flat_r, 'bbox': [round(v, 2) for v in bbox_r],
                       'score': round(0.7 + 0.25 * rng.rand(), 3),
                       'category_id': 1})

    _write_files(root, name, gt_lines, anns_l, anns_r,
                 persons_l=persons_l, persons_r=persons_r, rng=rng, images=images)
    return name


# ---------------------------------------------------------------------------
# Hard (adversarial) mode
# ---------------------------------------------------------------------------

def _ideal_box(x, z, y_top, scale, cam_shift=0.0):
    """Noise-free projected gt box (possibly outside the image) + joint pixels."""
    us, vs = [], []
    for dy, dx in _SKELETON:
        u, v = _project(x - cam_shift + dx * scale, y_top + dy * scale, z)
        us.append(u)
        vs.append(v)
    box = [min(us) - 1, min(vs) - 3, max(us) + 1, max(vs) + 3]
    return box, us, vs


def _clip_frac(box):
    """Fraction of box area lost when clipped to the image."""
    area = max(box[2] - box[0], 1e-6) * max(box[3] - box[1], 1e-6)
    cw = max(0.0, min(box[2], IM_W) - max(box[0], 0.0))
    ch = max(0.0, min(box[3], IM_H) - max(box[1], 0.0))
    return 1.0 - (cw * ch) / area


def _sample_hard_people(rng):
    """Sample a hard scene: clustered crowds + loners, wide z range, some
    near the image edge. Returns a list of person dicts sorted near-to-far."""
    people = []
    if rng.rand() < 0.18:                       # crowd scene
        n_groups = rng.randint(1, 3)
        for _ in range(n_groups):
            z_c = rng.uniform(7, 30)
            x_c = rng.uniform(-0.35, 0.35) * z_c
            for _ in range(rng.randint(4, 10)):
                people.append(dict(
                    z=max(4.0, z_c + rng.randn() * 0.12 * z_c),
                    x=x_c + rng.randn() * 1.1,
                    ry=rng.uniform(-math.pi * 0.9, math.pi * 0.9),
                    scale=rng.uniform(0.85, 1.15)))
    n_single = rng.randint(1, 5)
    for _ in range(n_single):
        z = rng.uniform(4, 50)
        if rng.rand() < 0.18:                   # near the horizontal FOV edge
            x = rng.choice([-1, 1]) * rng.uniform(0.7, 0.95) * z
        else:
            x = rng.uniform(-0.45, 0.45) * z
        people.append(dict(x=x, z=z, ry=rng.uniform(-math.pi * 0.9, math.pi * 0.9),
                           scale=rng.uniform(0.85, 1.15)))
    people.sort(key=lambda p: p['z'])
    return people


def _hard_annotation(us, vs, occluded, out_im, z, rng):
    """Noisy keypoints + detection box/score with pifpaf-like,
    confidence-correlated error. Returns (flat51, bbox_xywh, score)."""
    flat, xs_n, ys_n, confs = [], [], [], []
    for u, v, occ_j, out_j in zip(us, vs, occluded, out_im):
        if out_j:
            conf = rng.uniform(0.0, 0.15)
        elif occ_j:
            conf = rng.uniform(0.05, 0.35)
        else:
            conf = min(0.95, max(0.35, 0.9 - 0.004 * z + 0.1 * rng.randn()))
        sd = 0.4 + 5.0 * (1.0 - conf) ** 2
        un = u + rng.randn() * sd
        vn = v + rng.randn() * sd
        if rng.rand() < 0.02:                   # heavy-tail pifpaf confusion
            un += rng.randn() * 15.0
            vn += rng.randn() * 15.0
        un = min(max(un, -30.0), IM_W + 30.0)
        vn = min(max(vn, -30.0), IM_H + 30.0)
        xs_n.append(un)
        ys_n.append(vn)
        confs.append(conf)
        flat += [round(un, 2), round(vn, 2), round(conf, 3)]
    x1, y1 = min(xs_n) - 3, min(ys_n) - 5
    x2, y2 = max(xs_n) + 3, max(ys_n) + 5
    bbox = [x1, y1, max(x2 - x1, 2.0), max(y2 - y1, 2.0)]
    score = min(0.99, max(0.05,
                          0.25 + 0.65 * float(np.mean(confs)) + 0.05 * rng.randn()))
    return flat, bbox, score


def _false_positive(rng):
    """A hallucinated low-score skeleton at a random image location."""
    z = rng.uniform(8, 40)
    x = rng.uniform(-0.4, 0.4) * z
    _, us, vs = _ideal_box(x, z, -0.65, rng.uniform(0.7, 1.2))
    flat = []
    for u, v in zip(us, vs):
        flat += [round(u + rng.randn() * 6.0, 2), round(v + rng.randn() * 6.0, 2),
                 round(rng.uniform(0.05, 0.45), 3)]
    xs, ys = flat[0::3], flat[1::3]
    bbox = [min(xs) - 3, min(ys) - 5, max(xs) - min(xs) + 6, max(ys) - min(ys) + 10]
    return {'keypoints': flat, 'bbox': [round(v, 2) for v in bbox],
            'score': round(rng.uniform(0.1, 0.45), 3), 'category_id': 1}


def write_scene_hard(root, idx, people, rng, images=True):
    """Hard-mode scene writer: occlusion/truncation-aware gt + noisy,
    sometimes-missing annotations. `people` come from _sample_hard_people
    (sorted near-to-far)."""
    name = str(idx).zfill(6)
    y_tops = [-0.65 + rng.randn() * 0.05 for _ in people]
    boxes_l = [_ideal_box(p['x'], p['z'], yt, p['scale'])
               for p, yt in zip(people, y_tops)]
    boxes_r = [_ideal_box(p['x'], p['z'], yt, p['scale'], cam_shift=BASELINE)
               for p, yt in zip(people, y_tops)]

    gt_lines, anns_l, anns_r = [], [], []
    for i, (p, yt) in enumerate(zip(people, y_tops)):
        box, us, vs = boxes_l[i]
        trunc = _clip_frac(box)
        if trunc >= 0.85:
            continue                            # effectively outside the image
        # A joint is occluded when a CLOSER person's (ideal) box contains it.
        occluders = [boxes_l[j][0] for j in range(i)
                     if people[j]['z'] < p['z'] - 0.3]
        occluded = [any(b[0] <= u <= b[2] and b[1] <= v <= b[3]
                        for b in occluders) for u, v in zip(us, vs)]
        out_im = [not (0 <= u <= IM_W and 0 <= v <= IM_H)
                  for u, v in zip(us, vs)]
        occ_frac = sum(occluded) / len(occluded)
        occ = 0 if occ_frac <= 0.2 else (1 if occ_frac <= 0.55 else 2)

        h = PERSON_H * p['scale']
        y_center = yt + h / 2
        gx, gy, gz = p['x'], y_center + 0.85, p['z']
        alpha = p['ry'] - math.atan2(gx, gz)
        if alpha > math.pi:
            alpha -= 2 * math.pi
        elif alpha < -math.pi:
            alpha += 2 * math.pi
        gt_box = [max(box[0], 0.0), max(box[1], 0.0),
                  min(box[2], IM_W), min(box[3], IM_H)]
        gt_lines.append(
            f"Pedestrian {trunc:.2f} {occ} {alpha:.2f} "
            f"{gt_box[0]:.2f} {gt_box[1]:.2f} {gt_box[2]:.2f} {gt_box[3]:.2f} "
            f"{h:.2f} 0.65 0.80 {gx:.2f} {gy:.2f} {gz:.2f} {p['ry']:.2f}\n")

        # Detector miss probability grows with occlusion/truncation.
        p_miss = 0.0
        if occ_frac > 0.7 or trunc > 0.6:
            p_miss = 0.55
        elif occ_frac > 0.45 or trunc > 0.35:
            p_miss = 0.25
        elif occ_frac > 0.2:
            p_miss = 0.08
        if rng.rand() >= p_miss:
            flat, bbox, score = _hard_annotation(us, vs, occluded, out_im,
                                                 p['z'], rng)
            anns_l.append({'keypoints': flat,
                           'bbox': [round(v, 2) for v in bbox],
                           'score': round(score, 3), 'category_id': 1})
        # Right view: same occlusion structure, independent noise and miss.
        _, us_r, vs_r = boxes_r[i]
        out_im_r = [not (0 <= u <= IM_W and 0 <= v <= IM_H)
                    for u, v in zip(us_r, vs_r)]
        if rng.rand() >= p_miss:
            flat_r, bbox_r, score_r = _hard_annotation(
                us_r, vs_r, occluded, out_im_r, p['z'], rng)
            anns_r.append({'keypoints': flat_r,
                           'bbox': [round(v, 2) for v in bbox_r],
                           'score': round(score_r, 3), 'category_id': 1})

    while rng.rand() < 0.10:                    # hallucinated detections
        anns_l.append(_false_positive(rng))
    _write_files(root, name, gt_lines, anns_l, anns_r, images=images)
    return name


def make_dataset(root, n_train=16, n_val=8, seed=0, hard=False, images=True):
    """Write n_train + n_val scenes from `seed` under root; returns the
    (train, val) basenames."""
    rng = np.random.RandomState(seed)
    names = []
    total = n_train + n_val
    for i in range(1, total + 1):
        if hard:
            names.append(write_scene_hard(root, i, _sample_hard_people(rng), rng,
                                          images=images))
            continue
        n_people = rng.randint(1, 4)
        people = []
        for _ in range(n_people):
            z = rng.uniform(6, 35)
            x = rng.uniform(-0.35, 0.35) * z
            ry = rng.uniform(-math.pi * 0.9, math.pi * 0.9)
            people.append((x, z, ry))
        names.append(write_scene(root, i, people, rng, images=images))

    splits_dir = os.path.join(root, 'splits')
    os.makedirs(splits_dir, exist_ok=True)
    with open(os.path.join(splits_dir, 'kitti_train.txt'), 'w') as f:
        f.write('\n'.join(names[:n_train]) + '\n')
    with open(os.path.join(splits_dir, 'kitti_val.txt'), 'w') as f:
        f.write('\n'.join(names[n_train:]) + '\n')
    os.makedirs(os.path.join(root, 'data', 'arrays'), exist_ok=True)
    os.makedirs(os.path.join(root, 'data', 'outputs'), exist_ok=True)
    os.makedirs(os.path.join(root, 'data', 'logs'), exist_ok=True)
    return names[:n_train], names[n_train:]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('root')
    parser.add_argument('--n_train', type=int, default=16)
    parser.add_argument('--n_val', type=int, default=8)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--hard', action='store_true')
    parser.add_argument('--no-images', dest='images', action='store_false')
    args = parser.parse_args(argv)
    tr, va = make_dataset(args.root, n_train=args.n_train, n_val=args.n_val, seed=args.seed,
                          hard=args.hard, images=args.images)
    print(f"wrote {len(tr)} train + {len(va)} val scenes under {args.root}")


if __name__ == '__main__':
    main()
