"""Run the localization nets over KITTI validation pifpaf files and write
KITTI-format txt detections for evaluation: `GenerateKitti` of
`monoloco_tpu/eval/generate_kitti.py` on the port's engine.

Row layout per detection: `type -1 -1 alpha bbox(4) hwl xyz ry conf bi epi`,
with the reference's 0.035 (MonoLoco++) and 0.033 (MonStereo) confidence
scales. The images go sorted in chunks of 64, one `Loco.forward_batch_async`
dispatch each (two with MC dropout), two deep: chunk i+1 is on the device
while the host writes chunk i's txts. Under MONOLOCO_TPU_PRECISION=int8 each
chunk's MLP is the dyn8 kernel (64 images x the detection bucket, or x m x r
stereo pairings, is far above the engine's int8 floor), under bf16 the
K1-bf16 kernel.

`--baselines` in mono mode also writes the `monoloco` tree (the legacy
34 -> 2 net of `data/models/monoloco-190717-0952.pkl`, hidden 256, which
runs no kernel, as in the JAX package) and the `geometric` tree
(`geom_baseline.geometric_coordinates`) beside `monoloco_pp`. It takes the
JAX package's per-image loop: one dispatch of each net an image (the main
net's through dyn8 under int8 once an image pads to 16 rows). The stereo
baselines (pose and ReID association) need the ReID net and are refused
(ROADMAP Queue 1 item 8); so is a device mesh (item 9).
"""

import math
import os

import numpy as np

from ..geometry import get_category
from ..geometry.host import np_xyz_from_distance
from ..network import Loco, preprocess_pifpaf
from ..prep import factory_file
from ..utils import factory_basename, make_new_directory, read_and_rewrite
from .geom_baseline import geometric_coordinates

CHUNK = 64
STEREO_BASELINES_REFUSAL = ("eval --baselines in stereo mode needs the ReID net for its "
                            "stereo baselines: ROADMAP Queue 1 item 8")


class GenerateKitti:

    dir_gt = os.path.join('data', 'kitti', 'gt')
    dir_kk = os.path.join('data', 'kitti', 'calib')
    dir_byc = os.path.join('data', 'kitti', 'object_detection', 'left')
    monoloco_checkpoint = os.path.join('data', 'models', 'monoloco-190717-0952.pkl')

    def __init__(self, args):
        assert args.mode in ('mono', 'stereo'), "mode not recognized"
        if getattr(args, 'baselines', False) and args.mode == 'stereo':
            raise NotImplementedError(STEREO_BASELINES_REFUSAL)
        self.mode = args.mode
        self.net = 'monstereo' if args.mode == 'stereo' else 'monoloco_pp'
        device = 'cpu' if getattr(args, 'disable_cuda', False) else None
        self.model = Loco(model=args.model, mode=args.mode, device=device,
                          n_dropout=args.n_dropout, p_dropout=args.dropout,
                          linear_size=args.hidden_size, n_stage=args.n_stage,
                          mesh=getattr(args, 'mesh', None))
        self.dir_ann = args.dir_ann
        self.generate_official = getattr(args, 'generate_official', False)
        assert os.listdir(self.dir_ann), "Annotation directory is empty"
        self.set_basename = factory_basename(args.dir_ann, self.dir_gt)
        self.baselines = []
        if getattr(args, 'baselines', False):
            self.baselines = ['monoloco', 'geometric']
            self.monoloco = Loco(model=self.monoloco_checkpoint, mode='mono', net='monoloco',
                                 device=device, n_dropout=args.n_dropout,
                                 p_dropout=args.dropout, linear_size=256)

    def run(self, chunk=CHUNK):
        """Load every validation image's annotations, forward them in sorted
        chunks, and write one txt per image with detections. The stereo net's
        right pose choice per left pose is kept by basename in `aux_idx`."""
        dir_out = os.path.join('data', 'kitti', self.net)
        make_new_directory(dir_out)
        if self.baselines:
            return self._run_baselines(dir_out)
        stereo = self.net == 'monstereo'
        self.aux_idx = {}
        cnt_ann = cnt_file = cnt_no_file = 0
        loaded = []
        # sorted: chunk membership must be run-to-run deterministic: the
        # MC-dropout bucket shape (and hence the epi draws) depends on which
        # images share a chunk, and set iteration order is hash-randomized.
        for basename in sorted(self.set_basename):
            boxes, keypoints, kk, tt, cat, keypoints_r = self._load_image(basename, stereo)
            if not keypoints:
                cnt_no_file += 1
                continue
            loaded.append((basename, boxes, kk, tt, cat, keypoints, keypoints_r))

        def launch(start):
            batch = loaded[start:start + chunk]
            fin = self.model.forward_batch_async(
                [b[5] for b in batch], [b[2] for b in batch],
                keypoints_r_list=[b[6] for b in batch] if stereo else None)
            return batch, fin

        def drain(batch, fin):
            nonlocal cnt_ann, cnt_file
            for (basename, boxes, kk, tt, cat, _, _), dic_out in zip(batch, fin()):
                all_outputs = [dic_out['xyzd'], dic_out['bi'], dic_out['epi'],
                               dic_out['yaw'], dic_out['h'], dic_out['w'], dic_out['l']]
                save_txts(os.path.join(dir_out, basename + '.txt'), boxes, all_outputs,
                          [kk, tt], net=self.net, cat=cat)
                if stereo:
                    self.aux_idx[basename] = dic_out['aux_idx']
                cnt_ann += len(boxes)
                cnt_file += 1

        pending = None
        for start in range(0, len(loaded), chunk):
            launched = launch(start)
            if pending is not None:
                drain(*pending)
            pending = launched
        if pending is not None:
            drain(*pending)

        print(f"\nSaved in {cnt_file} txt {cnt_ann} annotations. "
              f"Not found {cnt_no_file} images")
        if self.generate_official:
            create_empty_files({self.net: dir_out}, self.net)

    def _run_baselines(self, dir_out):
        """The JAX package's per-image loop of `--baselines` (mono): the main
        net and the legacy MonoLoco one dispatch each an image, the
        geometric depths on the host; one txt an image in each tree."""
        dirs = {self.net: dir_out}
        for name in self.baselines:
            dirs[name] = os.path.join('data', 'kitti', name)
            make_new_directory(dirs[name])
        cnt_ann = cnt_file = cnt_no_file = 0
        for basename in sorted(self.set_basename):
            boxes, keypoints, kk, tt, cat, _ = self._load_image(basename, False)
            if not keypoints:
                cnt_no_file += 1
                continue
            dic_out = self.model.forward(keypoints, kk)
            outputs = [dic_out['xyzd'], dic_out['bi'], dic_out['epi'], dic_out['yaw'],
                       dic_out['h'], dic_out['w'], dic_out['l']]
            params = [kk, tt]
            save_txts(os.path.join(dir_out, basename + '.txt'), boxes, outputs, params,
                      net=self.net, cat=cat)
            cnt_ann += len(boxes)
            cnt_file += 1
            dic_mono = self.monoloco.forward(keypoints, kk)
            zzs_geom, xy_centers = geometric_coordinates(keypoints, kk, average_y=0.48)
            outputs = [dic_mono['d'], dic_mono['bi'], dic_mono['epi'], zzs_geom, xy_centers]
            for key in self.baselines:
                save_txts(os.path.join(dirs[key], basename + '.txt'), boxes, outputs, params,
                          net=key, cat=cat)
        print(f"\nSaved in {cnt_file} txt {cnt_ann} annotations. "
              f"Not found {cnt_no_file} images")
        if self.generate_official:
            create_empty_files(dirs, self.net)

    def _load_image(self, basename, load_right):
        """Annotations, calibration and category flags of one image; the
        right camera's keypoints only when the stereo net needs them."""
        path_calib = os.path.join(self.dir_kk, basename + '.txt')
        annotations, kk, tt = factory_file(path_calib, self.dir_ann, basename)
        boxes, keypoints = preprocess_pifpaf(annotations, im_size=(1242, 374))
        cat = get_category(keypoints, os.path.join(self.dir_byc, basename + '.json'))
        keypoints_r = None
        if load_right and keypoints:
            annotations_r, _, _ = factory_file(path_calib, self.dir_ann, basename,
                                               ann_type='right')
            _, keypoints_r = preprocess_pifpaf(annotations_r, im_size=(1242, 374))
        return boxes, keypoints, kk, tt, cat, keypoints_r


def save_txts(path_txt, all_inputs, all_outputs, all_params, net='monoloco', cat=None):
    """Write one KITTI-format txt: per row
    `type -1 -1 alpha bbox(4) hwl xyz ry conf bi epi`."""
    assert net in ('monoloco', 'monstereo', 'geometric', 'baseline', 'monoloco_pp')

    if net in ('monstereo', 'monoloco_pp'):
        xyzd, bis, epis, yaws, hs, ws, ls = all_outputs[:]
        xyz = np.asarray(xyzd)[:, 0:3]
        tt = [0, 0, 0]
    elif net in ('monoloco', 'geometric'):
        tt = [0, 0, 0]
        dds, bis, epis, zzs_geom, xy_centers = all_outputs[:]
        xyz = np_xyz_from_distance(np.asarray(dds).reshape(-1), xy_centers)
    else:
        _, tt = all_params[:]
        xyz, bis, epis, zzs_geom, xy_centers = all_outputs[:]
    uv_boxes = all_inputs[:]
    assert len(uv_boxes) == len(list(xyz)), \
        "Number of inputs different from number of outputs"

    with open(path_txt, 'w+') as ff:
        for idx, uv_box in enumerate(uv_boxes):
            xx = float(xyz[idx][0]) - tt[0]
            yy = float(xyz[idx][1]) - tt[1]
            zz = float(xyz[idx][2]) - tt[2]
            if net == 'geometric':
                zz = zzs_geom[idx]
            cam_0 = [xx, yy, zz]
            bi = float(np.asarray(bis[idx]).reshape(-1)[0])
            epi = float(np.asarray(epis[idx]).reshape(-1)[0])
            if net in ('monstereo', 'monoloco_pp'):
                alpha = float(np.asarray(yaws[0]).reshape(-1)[idx])
                ry = float(np.asarray(yaws[1]).reshape(-1)[idx])
                hwl = [float(np.asarray(v).reshape(-1)[0]) for v in (hs[idx], ws[idx], ls[idx])]
                conf_scale = 0.035 if net == 'monoloco_pp' else 0.033
            else:
                alpha, ry, hwl = -10., -10., [0, 0, 0]
                conf_scale = 0.05
            conf = conf_scale * (uv_box[-1]) / (bi / math.sqrt(xx ** 2 + yy ** 2 + zz ** 2))

            output_list = [alpha] + uv_box[:-1] + hwl + cam_0 + [ry, conf, bi, epi]
            category = cat[idx] if cat else 0.0
            ff.write("%s " % ('Pedestrian' if category < 0.1 else 'Cyclist'))
            ff.write("%i %i " % (-1, -1))
            for el in output_list:
                ff.write("%f " % el)
            ff.write("\n")


def create_empty_files(dir_out, net):
    """Empty txt files for the official KITTI evaluation folder layout: the
    published methods' folders rewritten from their `-orig` copies (empty
    where absent), and an empty txt for every KITTI image the net has none
    for."""
    methods = ['pseudo-lidar', 'monopsr', '3dop', 'm3d', 'oc-stereo', 'e2e',
               'monodis', 'smoke']
    dirs = [os.path.join('data', 'kitti', m) for m in methods]
    dirs_orig = [os.path.join('data', 'kitti', m + '-orig') for m in methods]
    for di, di_orig in zip(dirs, dirs_orig):
        make_new_directory(di)
        for i in range(7481):
            name = str(i).zfill(6) + '.txt'
            read_and_rewrite(os.path.join(di_orig, name), os.path.join(di, name))
    for i in range(7481):
        name = str(i).zfill(6) + '.txt'
        with open(os.path.join(dir_out[net], name), 'a+'):
            pass
