"""Inference engine: the `Loco` of `monoloco_tpu/network/engine.py` in torch,
mono (MonoLoco++) and stereo (MonStereo).

Per dispatch, on the engine's device: K^-1 keypoint normalization (for
stereo, the all-vs-all pairing of left and right poses), the BN-folded
residual MLP, for stereo the choice of each left pose's right partner by the
aux logit, and the physical decode. Everything after (ground truth matching,
output dict assembly, the activity rules) is host numpy on a handful of
detections.

MLP routing (`_mlp_forward`), as in the JAX package off the TPU:
 - default / float32: the plain f32 folded forward (`FoldedLoco`, torch.matmul);
 - int8: the fused dynamic-int8 kernel (ops/fused_mlp.py) for dispatches of
   at least `_INT8_MIN_ROWS` padded rows, the f32 path below that;
 - bfloat16: the K1-bf16 kernel (`fused_loco_forward` on a bf16 pack made
   once at init) for every dispatch of a Loco net with hidden % 128 == 0;
   the legacy nets and other widths run `folded_forward` on bf16-rounded
   operands (exact products, f32 sums), the same function without a kernel;
 - tensorfloat32: the f32 folded forward with TF32 on around the MLP only.
K^-1 and decode stay f32 under every precision.
`_INT8_MIN_ROWS = 16` is the crossover measured on an NVIDIA H100 80GB HBM3
at a 700 W power limit by `monoloco_tpu_torch/tools/bench_int8_crossover.py`
(the whole serving program, dyn8 against the f32 path it replaces, 16 to
131072 rows): in two runs dyn8 won at every measured row count, the
smallest being 16 (1.04-1.26x up to 2048 rows, where both are bound by the
host's launches; 1.95-2.40x at 8192, 7.1x at 131072). The JAX package's 512 was a TPU v5e's
dyn8/bf16 crossover. MONOLOCO_TPU_INT8_MIN_ROWS overrides it.

A stereo dispatch has m x r rows (B x m x r in a batch), so it crosses the
floor sooner than a mono one.

Detection counts pad to power-of-two buckets (`_bucket`): the JAX package
needs them to bound recompiles, and here routing reads the padded row count,
so both engines route a given batch the same way. Stereo pads m and r to
their buckets separately; padded right columns cannot win the aux argmax.

MC-dropout epistemic uncertainty (`n_dropout > 0`, mono nets; stereo keeps
epi at zeros, as in the JAX package) is one more dispatch after the main
one: the n_dropout passes stacked on a leading axis through
`folded_forward_mc` (the folded f32 net on the device, TF32 off, under every
precision), 100 Laplace samples a pass and the std over all of them. The
keep-masks and the uniforms come from torch.Generators on the device made
afresh on every dispatch (seed 0 and 1): the same for every pass's uniforms
and, in a batch, for every image, as the JAX package's fixed keys and its
vmap over images make them. `forward`, `forward_batch` and
`forward_batch_async` also take them injected (`mc=(masks, u)`), and
`mc_last` keeps the last ones drawn.

Under a mesh (`mesh=`, a `parallel.Mesh`; every rank builds the same Loco
and calls `forward_batch_async` with the same images), the image bucket
pads to a multiple of the data ranks, each rank runs its share of the
images through the same routing (so dyn8 from 16 padded rows a rank, and
K1-bf16 under bf16), and the outputs are all-gathered over the data group:
every rank gets what one device computes. The dispatch counters count the
rows of a rank's share, as the JAX engine's `_dispatch_shard_factor`. A
mesh with a model axis above 1 computes the data shards alike on the ranks
of a model group, with the full weights; it warns and drops the int8 route,
as the JAX engine does (its Pallas kernel has no partitioning rule over the
model axis). `forward`, one image, computes locally on every rank.
"""

import math
import os
import warnings
from collections import defaultdict

import numpy as np
import torch

from ..activity import is_raising_hand, social_interactions
from ..geometry import get_iou_matches, reorder_matches
from ..geometry.host import np_get_keypoints, np_pixel_to_camera, np_xyz_from_distance
from ..geometry.stereo import BF, mask_joint_disparity
from ..models import (FoldedLoco, dropout_masks, fold_eval_params, folded_forward,
                      folded_forward_mc, load_checkpoint, n_dropout_sites, params_from_numpy,
                      round_bf16)
from ..parallel import gather_rows, row_range
from ..ops import (fused_loco_forward, fused_loco_forward_dyn8_auto, pack_folded_weights,
                   pack_folded_weights_w8)
from ..utils.precision import serve_storage, serving_precision, tf32_matmuls
from .decode import (extract_outputs, extract_outputs_mono, laplace_sampling,
                     laplace_uniforms, unnormalize_bi)
from .preprocess import preprocess_monoloco, preprocess_monstereo

N_SAMPLES = 100
# The measured dyn8-vs-f32 crossover on the H100 (module docstring).
_INT8_MIN_ROWS = int(os.environ.get('MONOLOCO_TPU_INT8_MIN_ROWS', '16'))


def _int8_routes(weights, n_rows):
    """Whether an n_rows dispatch runs the dyn8 kernel. Shared by
    `_mlp_forward` and the dispatch counters, so the two never disagree."""
    return (isinstance(weights, dict)
            and weights.get('packed_int8') is not None
            and n_rows >= _INT8_MIN_ROWS)


def _mlp_forward(weights, inputs, arch):
    """Eval MLP. `weights` is Loco's {'folded': FoldedLoco, 'packed_int8':
    dyn8 weights or None, 'packed_bf16': K1-bf16 weights or None,
    'precision': the canonical precision}, or a bare folded dict from direct
    callers (plain f32)."""
    if not (isinstance(weights, dict) and 'folded' in weights):
        return folded_forward(weights, inputs, arch=arch)
    if _int8_routes(weights, inputs.shape[0]):
        return fused_loco_forward_dyn8_auto(weights['packed_int8'], inputs)
    if weights.get('packed_bf16') is not None:
        return fused_loco_forward(None, inputs, packed=weights['packed_bf16'])
    precision = weights.get('precision')
    if precision == 'bfloat16':
        return folded_forward(weights['folded'].folded(), inputs, arch=arch,
                              operand=round_bf16)
    if precision == 'tensorfloat32':
        with tf32_matmuls():
            return weights['folded'](inputs)
    return weights['folded'](inputs)


def _bucket(n, minimum=4):
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_rows(arr, size):
    m = arr.shape[0]
    if m == size:
        return np.asarray(arr, np.float32)
    out = np.zeros((size,) + arr.shape[1:], np.float32)
    out[:m] = arr
    return out


def _to_host(dic):
    return {k: (tuple(t.cpu().numpy() for t in v) if k == 'yaw' else v.cpu().numpy())
            for k, v in dic.items()}


def default_device():
    """The card. Without one this raises: the CPU runs only when asked for
    (`device='cpu'`, `predict --disable-cuda`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found: pass device='cpu' (predict: --disable-cuda) "
                           "to run on the CPU")
    return torch.device('cuda')


class Loco:
    """Load a localization net and run preprocess -> forward -> postprocess."""

    NETS = ('monstereo', 'monoloco_pp', 'monoloco_p', 'monoloco')

    def __init__(self, model, mode='mono', net=None, device=None, n_dropout=0,
                 p_dropout=0.2, linear_size=1024, n_stage=3, mesh=None):
        if mode not in ('mono', 'stereo'):
            raise ValueError(f"mode not recognized: {mode}")
        self.mode = mode
        self.mesh = mesh
        if net is None:
            net = 'monoloco_pp' if mode == 'mono' else 'monstereo'
        if net not in self.NETS:
            raise ValueError(f"net not recognized: {net}")
        self.net = net
        self.arch = 'monoloco' if self.net in ('monoloco', 'monoloco_p') else 'loco'
        self.n_dropout = n_dropout
        self.p_dropout = p_dropout
        self.mc_last = None
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device) if device is not None else default_device()

        if isinstance(model, (str, os.PathLike)):
            self.params, self.bn_state, _ = load_checkpoint(model, device=self.device)
        elif isinstance(model, tuple):
            self.params, self.bn_state = params_from_numpy(*model, device=self.device)
        else:
            raise TypeError("model must be a checkpoint path or a (params, bn_state) tuple")
        # linear_size and n_stage are hints, as in the JAX package: the
        # checkpoint is the source of truth for the architecture size.
        self.linear_size = int(self.params['w1']['w'].shape[1])
        self.n_stage = int(self.params['stages']['w1']['w'].shape[0])
        self.folded = fold_eval_params(self.params, self.bn_state, arch=self.arch)
        self.precision = serving_precision()
        # The spelling as given (serve's /healthz reports it, as the JAX
        # server reports its `utils.precision._RAW`).
        self.precision_raw = os.environ.get('MONOLOCO_TPU_PRECISION', 'default')
        # Weights are stored f32 (the JAX package casts to bf16 only on a
        # TPU); under int8 the dyn8 weights and under bfloat16 the K1-bf16
        # weights are packed once, here, for mono and the stereo pairing
        # alike. MC dropout runs the f32 `FoldedLoco` under every precision.
        self.serve_storage = serve_storage()
        self.mlp_weights = {'folded': FoldedLoco(self.folded, self.arch).to(self.device),
                            'packed_int8': None, 'packed_bf16': None,
                            'precision': self.precision}
        kernel_width = self.arch == 'loco' and self.linear_size % 128 == 0
        if self.precision == 'int8' and kernel_width:
            if mesh is not None and mesh.tp > 1:
                warnings.warn(
                    "MONOLOCO_TPU_PRECISION=int8 is ignored under a device mesh with a model "
                    "axis: the int8 route serves data shards only. Serving the float32 path "
                    "instead.", RuntimeWarning)
            else:
                self.mlp_weights['packed_int8'] = pack_folded_weights_w8(self.folded)
        if self.precision == 'bfloat16' and kernel_width:
            self.mlp_weights['packed_bf16'] = pack_folded_weights(self.folded, torch.bfloat16)
        # Which MLP path each dispatch ran: the int8 kernel only engages at
        # >= _INT8_MIN_ROWS padded rows. One count a call of `forward` or
        # `forward_batch_async`, its MC dispatch included, as the JAX engine
        # counts them; serve's /healthz and /metrics export both.
        self.n_dispatches = 0
        self.n_dispatches_int8 = 0

    def _count_dispatch(self, n_rows):
        self.n_dispatches += 1
        if _int8_routes(self.mlp_weights, n_rows):
            self.n_dispatches_int8 += 1

    def _mono_forward(self, kps, kk):
        """Keypoints (m, 3, 17) with kk (3, 3), or an image batch (B, m, 3,
        17) with kk (B, 3, 3), on the device -> the decoded output dict over
        all B*m rows."""
        if self.net == 'monoloco':
            inputs = preprocess_monoloco(kps, kk, zero_center=True)
            raw = _mlp_forward(self.mlp_weights, inputs, self.arch)
            return {'d': raw[:, 0:1], 'bi': unnormalize_bi(raw)}
        inputs = preprocess_monoloco(kps, kk)
        raw = _mlp_forward(self.mlp_weights, inputs.reshape(-1, inputs.shape[-1]),
                           self.arch)
        if self.net == 'monoloco_p':
            return extract_outputs_mono(raw)
        return extract_outputs(raw)

    def _stereo_forward(self, kps_l, kps_r, r_mask, kk):
        """An image batch on the device: left (B, m, 3, 17), right (B, r, 3,
        17), r_mask (B, r) bool, kk (B, 3, 3) -> (the decoded output dict over
        the B*m left poses, each with its chosen pairing, and the (B, m)
        index of the right pose chosen). One MLP call over the B*m*r pairs;
        the JAX package vmaps the same program over the images."""
        b, m, r = kps_l.shape[0], kps_l.shape[1], kps_r.shape[1]
        inputs, _ = preprocess_monstereo(kps_l, kps_r, kk)          # (B, m*r, 68)
        raw = _mlp_forward(self.mlp_weights, inputs.reshape(b * m * r, -1), 'loco')
        out4 = raw.reshape(b, m, r, raw.shape[-1])
        # Padded right columns cannot win the aux argmax; the first maximum
        # wins a tie, as in jnp.argmax.
        aux = torch.where(r_mask[:, None, :], out4[..., -1],
                          torch.full_like(out4[..., -1], -math.inf))
        best = torch.argmax(aux, dim=2)                              # (B, m)
        selected = torch.take_along_dim(out4, best[:, :, None, None], dim=2)[:, :, 0, :]
        return extract_outputs(selected.reshape(b * m, -1)), best

    def draw_mc(self, rows):
        """(masks, u) for one MC dispatch over images of `rows` padded
        detections: `n_dropout_sites` keep-masks (n_dropout, rows, hidden)
        bool and the Laplace uniforms (N_SAMPLES, rows), on the device, from
        generators seeded 0 and 1 afresh on every call."""
        masks = dropout_masks(self.n_dropout, rows, self.linear_size,
                              n_dropout_sites(self.n_stage, self.arch), self.p_dropout,
                              self.device, seed=0)
        return masks, laplace_uniforms(N_SAMPLES, rows, self.device, seed=1)

    def mc_epistemic(self, kps, kk, mc=None):
        """The epistemic std of an image batch in one dispatch: kps (B, m, 3,
        17) and kk (B, 3, 3) on the device -> (B, m) f32. The n_dropout
        passes run stacked, (n_dropout, B, m, H), with every image's masks
        alike; each pass's distance mean and Laplace spread (columns 0:2 of
        the legacy 'monoloco' net, 2:4 otherwise) give N_SAMPLES samples, and
        the std (ddof 1) is over all n_dropout * N_SAMPLES of them. `mc` is
        (masks, u) as `draw_mc` makes them (drawn here when None); kept in
        `mc_last`."""
        masks, u = self.draw_mc(kps.shape[1]) if mc is None else mc
        self.mc_last = (masks, u)
        if self.net == 'monoloco':                   # per image only, B = 1
            x = preprocess_monoloco(kps[0], kk[0], zero_center=True)[None]
        else:
            x = preprocess_monoloco(kps, kk)                                # (B, m, in)
        out = folded_forward_mc(self.mlp_weights['folded'].folded(), x,
                                [keep[:, None] for keep in masks], self.p_dropout, self.arch)
        db = out[..., 0:2] if self.net == 'monoloco' else out[..., 2:4]     # (n, B, m, 2)
        mu_b = torch.cat([db[..., 0:1], unnormalize_bi(db)], dim=-1)
        samples = laplace_sampling(mu_b.transpose(0, 1), N_SAMPLES, u=u)   # (B, n, S, m)
        return torch.std(samples.reshape(kps.shape[0], -1, kps.shape[1]), dim=1, correction=1)

    def _mc_on(self):
        return self.n_dropout > 0 and self.net != 'monstereo'

    def forward(self, keypoints, kk, keypoints_r=None, mc=None):
        """One image: keypoints (m, 3, 17), kk (3, 3), and for the stereo net
        the right image's keypoints (r, 3, 17) (None or empty: the first left
        pose stands in) -> dict of numpy arrays (m rows each; 'yaw' is a
        (pred, egocentric) pair; stereo adds 'aux' and 'aux_idx', the right
        pose chosen per left pose). 'epi' is the MC-dropout std with
        n_dropout > 0 on a mono net (`mc`: injected draws for `mc_epistemic`,
        over the padded bucket), else zeros."""
        if keypoints is None or len(keypoints) == 0:
            return None
        kps = np.asarray(keypoints, np.float32)
        m = kps.shape[0]
        bm = _bucket(m)
        kk_dev = torch.as_tensor(np.asarray(kk, np.float32), device=self.device)
        epi = None
        with torch.inference_mode():
            if self.net == 'monstereo':
                if keypoints_r is None or len(keypoints_r) == 0:
                    kps_r = kps[0:1].copy()
                else:
                    kps_r = np.asarray(keypoints_r, np.float32)
                r = kps_r.shape[0]
                br = _bucket(r)
                r_mask = np.zeros((1, br), bool)
                r_mask[0, :r] = True
                self._count_dispatch(bm * br)
                dic, best = self._stereo_forward(
                    torch.from_numpy(_pad_rows(kps, bm)[None]).to(self.device),
                    torch.from_numpy(_pad_rows(kps_r, br)[None]).to(self.device),
                    torch.from_numpy(r_mask).to(self.device), kk_dev[None])
                dic['aux_idx'] = best[0]
            else:
                self._count_dispatch(bm)
                kps_dev = torch.from_numpy(_pad_rows(kps, bm)).to(self.device)
                dic = self._mono_forward(kps_dev, kk_dev)
                if self._mc_on():
                    epi = self.mc_epistemic(kps_dev[None], kk_dev[None], mc)[0, :m].cpu().numpy()
            dic = _to_host(dic)
        dic_out = {k: (v[0][:m], v[1][:m]) if k == 'yaw' else v[:m]
                   for k, v in dic.items()}
        dic_out['epi'] = [0.] * m if epi is None else epi
        return dic_out

    def forward_batch(self, keypoints_list, kk_list, keypoints_r_list=None, mc=None):
        """Run many images in one dispatch (see forward_batch_async)."""
        return self.forward_batch_async(keypoints_list, kk_list, keypoints_r_list, mc)()

    def forward_batch_async(self, keypoints_list, kk_list, keypoints_r_list=None, mc=None):
        """Launch one dispatch over many images; returns a zero-arg finalize()
        producing the per-image output dicts (None for an image without
        detections), identical in layout to `forward`'s.
        With n_dropout > 0 on a mono net a second dispatch computes 'epi'
        for the whole batch (`mc`: injected draws over the shared detection
        bucket, see `mc_epistemic`).

        keypoints_r_list (stereo net): per-image right keypoints (r_i, 3, 17);
        an entry may be None or empty, and then the image's first left pose
        stands in, as in `forward`.

        CUDA launches are asynchronous, so the caller can prepare the next
        chunk or write files before finalize() waits for this one. Images pad
        to shared detection buckets, as in the JAX package.
        """
        if self.net not in ('monoloco_pp', 'monoloco_p', 'monstereo'):
            raise ValueError("forward_batch supports the monoloco_pp, monoloco_p and "
                             "monstereo nets")
        counts = [0 if k is None else len(k) for k in keypoints_list]
        n_img = len(keypoints_list)
        if n_img == 0:
            return lambda: []
        m_bucket = _bucket(max(max(counts), 1))
        b_bucket = _bucket(n_img, minimum=1)
        dp = 1 if self.mesh is None else self.mesh.dp
        if dp > 1:
            # The image axis splits over the data ranks: pad the batch bucket
            # up to a multiple of them.
            b_bucket = max(b_bucket, dp)
            b_bucket += (-b_bucket) % dp
        lo, hi = (0, b_bucket) if dp == 1 else row_range(b_bucket, self.mesh)
        kps = np.zeros((b_bucket, m_bucket, 3, 17), np.float32)
        kks = np.zeros((b_bucket, 3, 3), np.float32)
        kks[:] = np.eye(3)
        for i, (k, kk) in enumerate(zip(keypoints_list, kk_list)):
            if counts[i]:
                kps[i, :counts[i]] = np.asarray(k, np.float32)
            kks[i] = np.asarray(kk, np.float32)

        def dev(arr):
            """This rank's images of a batch array, on the device."""
            return torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(self.device)

        def gather(dic):
            if self.mesh is None:
                return dic
            return {k: (tuple(gather_rows(t, self.mesh) for t in v) if k == 'yaw'
                        else gather_rows(v, self.mesh)) for k, v in dic.items()}

        epi_dev = None
        with torch.inference_mode():
            if self.net == 'monstereo':
                if keypoints_r_list is None:
                    keypoints_r_list = [None] * n_img
                counts_r = [0 if k is None else len(k) for k in keypoints_r_list]
                r_bucket = _bucket(max(max(counts_r), 1))
                kps_r = np.zeros((b_bucket, r_bucket, 3, 17), np.float32)
                r_mask = np.zeros((b_bucket, r_bucket), bool)
                for i in range(n_img):
                    if counts_r[i]:
                        kps_r[i, :counts_r[i]] = np.asarray(keypoints_r_list[i], np.float32)
                        r_mask[i, :counts_r[i]] = True
                    elif counts[i]:
                        # No right detections: the first left pose stands in.
                        kps_r[i, 0] = kps[i, 0]
                        r_mask[i, 0] = True
                self._count_dispatch((hi - lo) * m_bucket * r_bucket)
                dic_dev, best = self._stereo_forward(dev(kps), dev(kps_r), dev(r_mask),
                                                     dev(kks))
                dic_dev['aux_idx'] = best.reshape(-1)
                dic_dev = gather(dic_dev)
            else:
                self._count_dispatch((hi - lo) * m_bucket)
                kps_dev, kks_dev = dev(kps), dev(kks)
                dic_dev = gather(self._mono_forward(kps_dev, kks_dev))
                if self._mc_on():
                    epi_dev = self.mc_epistemic(kps_dev, kks_dev, mc)
                    if self.mesh is not None:
                        epi_dev = gather_rows(epi_dev, self.mesh)

        def finalize():
            dic = _to_host(dic_dev)
            epi = None if epi_dev is None else epi_dev.cpu().numpy()
            outs = []
            for i in range(n_img):
                m = counts[i]
                if m == 0:
                    outs.append(None)
                    continue
                sl = slice(i * m_bucket, i * m_bucket + m)
                dic_i = {k: (v[0][sl], v[1][sl]) if k == 'yaw' else v[sl]
                         for k, v in dic.items()}
                dic_i['epi'] = [0.] * m if epi is None else epi[i, :m]
                outs.append(dic_i)
            return outs

        return finalize

    @staticmethod
    def post_process(dic_in, boxes, keypoints, kk, dic_gt=None, iou_min=0.3,
                     reorder=True, verbose=False):
        """Assemble the final per-image output dict (the reference's key set
        and confidence formula conf = 0.035*box_conf/(bi/distance)). A copy of
        the JAX package's host code, defaultdict quirks included."""
        dic_out = defaultdict(list)
        if dic_in is None:
            return dic_out

        if dic_gt:
            boxes_gt = dic_gt['boxes']
            dds_gt = [el[3] for el in dic_gt['ys']]
            matches = get_iou_matches(boxes, boxes_gt, iou_min=iou_min)
            if verbose:
                print(f"found {len(matches)} matches with ground-truth")
            idxs_matches = [el[0] for el in matches]
            not_matches = [idx for idx, _ in enumerate(boxes) if idx not in idxs_matches]
        else:
            matches = []
            not_matches = list(range(len(boxes)))
            if verbose:
                print("NO ground-truth associated")

        if reorder and matches:
            matches = reorder_matches(matches, boxes, mode='left_right')

        all_idxs = [idx for idx, _ in matches] + not_matches
        dic_out['gt'] = [True] * len(matches) + [False] * len(not_matches)
        # Original annotation index of each output row.
        dic_out['indices'] = [int(i) for i in all_idxs]

        kps_np = np.asarray(keypoints, np.float32)
        uv_shoulders = np_get_keypoints(kps_np, 'shoulder')
        uv_heads = np_get_keypoints(kps_np, 'head')
        uv_centers = np_get_keypoints(kps_np, 'center')
        xy_centers = np_pixel_to_camera(uv_centers, kk, 1)

        has_yaw = 'yaw' in dic_in
        if has_yaw:
            yaw_pred = np.asarray(dic_in['yaw'][0]).reshape(-1)
            yaw_orig = np.asarray(dic_in['yaw'][1]).reshape(-1)
        has_aux = 'aux' in dic_in

        for idx in all_idxs:
            kps = keypoints[idx]
            box = boxes[idx]
            dd_pred = float(np.asarray(dic_in['d'][idx]).reshape(-1)[0])
            bi = float(np.asarray(dic_in['bi'][idx]).reshape(-1)[0])
            var_y = float(np.asarray(dic_in['epi'][idx]).reshape(-1)[0])
            uu_s, vv_s = uv_shoulders[idx][0:2]
            uu_c, vv_c = uv_centers[idx][0:2]
            uu_h, vv_h = uv_heads[idx][0:2]
            xyz_pred = np_xyz_from_distance(dd_pred, xy_centers[idx])[0]
            distance = math.sqrt(float(xyz_pred[0]) ** 2 + float(xyz_pred[1]) ** 2
                                 + float(xyz_pred[2]) ** 2)
            conf = 0.035 * (box[-1]) / (bi / distance)

            dic_out['boxes'].append(box)
            dic_out['confs'].append(conf)
            dic_out['dds_pred'].append(dd_pred)
            dic_out['stds_ale'].append(bi)
            dic_out['stds_epi'].append(var_y)
            dic_out['xyz_pred'].append([float(x) for x in xyz_pred])
            dic_out['uv_kps'].append(kps)
            dic_out['uv_centers'].append([round(float(uu_c)), round(float(vv_c))])
            dic_out['uv_shoulders'].append([round(float(uu_s)), round(float(vv_s))])
            dic_out['uv_heads'].append([round(float(uu_h)), round(float(vv_h))])

            if has_yaw:
                dic_out['angles'].append(float(yaw_pred[idx]))
                dic_out['angles_egocentric'].append(float(yaw_orig[idx]))
                if has_aux:
                    dic_out['aux'].append(float(np.asarray(dic_in['aux'][idx]).reshape(-1)[0]))
                else:
                    # Schema quirk of the reference: its defaultdict touches
                    # dic_out['aux'] before the KeyError on dic_in['aux'], so
                    # mono outputs carry an empty "aux": [] that the
                    # byte-compat golden pins.
                    dic_out['aux']  # noqa: B018 — deliberate defaultdict touch
            else:
                # Same quirk for the legacy 2-output net: 'angles' is touched
                # before the KeyError on dic_in['yaw'].
                dic_out['angles']  # noqa: B018 — deliberate defaultdict touch

        for idx, idx_gt in matches:
            dd_real = dds_gt[idx_gt]
            xyz_real = np_xyz_from_distance(dd_real, xy_centers[idx])
            dic_out['dds_real'].append(dd_real)
            dic_out['boxes_gt'].append(boxes_gt[idx_gt])
            dic_out['xyz_real'].append([float(x) for x in xyz_real.squeeze()])
        return dic_out

    @staticmethod
    def social_distance(dic_out, args):
        """Flag social-distancing violations per person, from
        args.threshold_prob, args.threshold_dist and args.radii."""
        angles = dic_out['angles']
        dds = dic_out['dds_pred']
        stds = dic_out['stds_ale']
        xz_centers = [[xx[0], xx[2]] for xx in dic_out['xyz_pred']]
        dic_out['social_distance'] = [
            bool(social_interactions(idx, xz_centers, angles, dds, stds=stds,
                                     threshold_prob=args.threshold_prob,
                                     threshold_dist=args.threshold_dist,
                                     radii=args.radii))
            for idx, _ in enumerate(dic_out['xyz_pred'])
        ]
        return dic_out

    @staticmethod
    def raising_hand(dic_out, keypoints):
        dic_out['raising_hand'] = [is_raising_hand(kp) for kp in keypoints]
        return dic_out


def median_disparity(dic_out, keypoints, keypoints_r, mask=None):
    """Ablation: replace the stereo net's depth with the median joint
    disparity wherever a confident stereo match exists. dic_out['xyzd'] is
    updated (numpy) and dic_out returned.

    The winning right candidate per left keypoint comes from `mask` (an (m,
    r) selection matrix, the form `filter_outputs` returns) or, when mask is
    None, from dic_out['aux_idx'] as the engine's stereo `forward` returns
    it. Host numpy, a copy of the JAX package's."""
    keypoints = np.asarray(keypoints)
    keypoints_r = np.asarray(keypoints_r)
    if mask is None:
        idx_right = np.asarray(dic_out['aux_idx']).reshape(-1)
    else:
        idx_right = np.argmax(np.asarray(mask), axis=1)
    avg_disparities, _, _ = mask_joint_disparity(keypoints, keypoints_r)
    xyzd = np.asarray(dic_out['xyzd']).copy()
    for idx, aux in enumerate(np.asarray(dic_out['aux']).reshape(-1)):
        if aux > 0.5:
            idx_r = int(idx_right[idx])
            z = BF / avg_disparities[idx][idx_r]
            if 1 < z < 80:
                xyzd[idx][2] = z
                xyzd[idx][3] = np.linalg.norm(xyzd[idx][0:3])
    dic_out['xyzd'] = xyzd
    return dic_out
