#!/usr/bin/env python3
"""Drive the torch port's main paths once on one CUDA card and check them.

Run from the root of a checkout, with no arguments:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, nothing falls back
to the CPU):
 1. Device: card name and power limit, torch and CUDA versions, and the
    build of the kernels from monoloco_tpu_torch/ops/csrc/.
 2. Kernel vs plain at full width (hidden 1024, 3 stages, 34 -> 9, weights
    from a seed with perturbed BN statistics) for m in M_ROWS.
 3. Row independence: kernel(x[:m]) == kernel(x)[:m] bit for bit.
 4. Main path through the CLI entry point: 64 images x 16 detections under
    MONOLOCO_TPU_PRECISION=int8 (1024 padded rows, so int8 routes), then
    the same run at float32 to bound the int8 deviation of dds_pred.
 5. Reference agreement: the f32 engine on the byte-compat checkpoint and
    fixture against the reference's out.monoloco.json.
 6. Times on the card at 131072 x 34: every kernel and its plain version,
    and the f32 and bf16 folded MLPs in `torch.matmul`; dyn8 also at 1024
    rows, the predict dispatch; for every kernel (all are layered: K1-bf16,
    K1-f32, dyn8, K4, K5), the device time of each CUDA kernel of one call
    (torch.profiler, the per-call weight transposes included) and the peak
    device memory of one call (their activation scratch); and a layer-level
    yardstick for the s8 layers of dyn8 and K4: `torch._int_mm` (s8 x s8 ->
    s32, the one PyTorch call for a layer's product) at 131072 x 1024 x 1024
    beside their per-launch device times.
 7. The K1 (bf16 and f32 weights), static a8w8 (K4) and w8a16 (K5) kernels
    against their plain versions at full width for m in M_ROWS, and at
    68 -> 10 for m = 77; row independence bit for bit; launch counters; and
    at 131072 x 1024 one H x H layer against its plain layer: of
    csrc/wgmma_layer.cu (bf16 and int8 weights, 'add_relu'), a 3xTF32 layer
    of csrc/wgmma_layer_kmajor.cu ('add_relu', within 1e-5 (1 + |ref|)), a
    dyn8 layer (row quantization + s8 layer, each epilogue, bit for bit) and
    a static a8w8 layer (each epilogue, bit for bit, the next layer's int8
    input included).
 7b. K6, `relu_chain` (the roofline probe's 8 bf16 relu layers on
    csrc/relu_chain.cu), against `relu_chain_plain` at 131072 x 1024 x 8
    under the bf16 rule; against the path it ran on before (csrc/
    wgmma_layer.cu's relu layer with a zero bias) bit for bit, or under the
    bf16 rule with the difference printed, there and at m = 1, 127, 129 and
    257; rows independent at m = 512 and 131071. Phase 6 times it beside
    that path, its plain version and the `torch.matmul` chain, in turns,
    and both kernels launch by launch.
 8. The serving bench and the ablation tools, as a user runs them:
    `monoloco_tpu_torch.bench` unpinned (bf16 + dyn8) and pinned int8-a8,
    int8-xla and f32; the six variants of `tools.bench_pallas_int8` and its
    pallas-f32; `tools.bench_pallas_crossover` at hidden 1024, batch 256 and
    131072. Each JSON line is printed; each checksum must be finite and
    each kernel variant must have launched its kernel.
 9. The stereo main path through the CLI entry point: MonStereo at full
    width (68 -> 10, hidden 1024, 3 stages, weights from a seed as in phase
    4), 64 (left, right) pairs of the fixture, 16 poses each, the right
    poses shifted left by BF / z: `predict --mode stereo` under int8 (one
    16384-row dispatch, the dyn8 kernel) and at float32 (no launch). The
    outputs are held against the rows recomputed outside the engine, and
    int8 against float32 under the dyn8 budget where both chose the same
    right pose (the share that did not is printed).
 10. dyn8 at 68 -> 10, hidden 1024, against its plain version on pairing
    rows from `preprocess_monstereo` (77, 1024 and 16384 rows), rows
    independent bit for bit.
 11. The roofline tool as a user runs it
    (`monoloco_tpu_torch.tools.bench_roofline`): its four JSON rows are
    printed, each checksum must be finite and `relu_chain` must launch.
 12. MC dropout and activities through the CLI entry point: phase 4's run
    with `--n_dropout 10 --activities social_distance raise_hand`, at
    float32 and at int8 (one main dispatch, dyn8 once under int8, and one
    MC dispatch of 10 x 1024 rows in f32). stds_epi is finite and > 0 for
    every detection and is the MC dispatch's epi; every other key equals
    phase 4's run at the same precision bit for bit; int8's epi equals
    float32's; social_distance and raising_hand equal their host
    recomputation from the JSON; the card's epi is recomputed on the CPU
    (plain f32) from the masks and uniforms the card drew, within 1e-4
    relative. One MC dispatch is timed (CUDA events, median of 7).
 13. The same run at bf16 (K1-bf16 on the dispatch, no dyn8; dds_pred
    within 0.02 mean relative of float32) and tensorfloat32 (no launch,
    allow_tf32 off after), each deviation printed and each epi equal to
    float32's; K1-bf16 timed at the 1024-row predict dispatch beside dyn8.
 14. `--mode keypoints --output_types json` builds no engine and launches
    nothing; one float32 run under `--profile` gives the device's busy
    share of predict (CUDA kernel time over the profiled wall).
 15. The serving entry point: `python -m monoloco_tpu_torch.serve --model
    <phase 4's checkpoint> --port 0` under int8 in a subprocess; /healthz
    (int8, kernel packed), 64 concurrent keep-alive clients x 8 POSTs of
    the fixture's 16 detections (boxes on every other one), /metrics (int8
    dispatches, nothing shed, batches coalesced), every distance against an
    in-process float32 Loco under the dyn8 budget, SIGTERM -> exit 0 in 10 s.
 16. In-process `Server`s on port 0 under the same clients, launches
    counted: mono int8 (dyn8), MonStereo int8 (16 left and 16 right poses a
    request; dyn8 at 68 -> 10, distances against float32 where both chose
    the same right pose), mono bf16 (K1-bf16 on every dispatch, within 0.02
    of float32) and mono default (no launch, each response equal to
    `Loco.forward_batch` of a batch of its dispatch's size within 1e-5 (1 +
    |ref|)); each run under torch.profiler for the device's busy share.
 17. The serving tools as a user runs them: `tools.bench_serve` closed loop
    (32 clients x 20 requests x 16 detections) under int8 (with
    `--expect-int8`), default and bf16, and `--direct --sweep
    500,2000,8000 --duration 2` under int8; `tools.bench_latency --batches
    1,16,256,4096` (default, bf16, int8); `tools.bench_int8_crossover` at 16
    to 131072 rows. Every JSON line printed, every checksum finite.
 18. KITTI txt generation and ALE/ALP evaluation through the entry point:
    a hard-mode synthetic KITTI root (seed 1, 1000 val scenes, cut from
    KITTI's 3769 to make room for phases 24-28; no images,
    `tools.make_synthetic_kitti`), then `run.main(['eval', '--generate',
    ...])` with phase 4's checkpoint at float32, int8 and bf16 (64-image
    chunks, one dispatch each: every int8 chunk launches dyn8, every bf16
    chunk K1-bf16, float32 nothing), a JSON line per run (the entry
    point's wall and images/s, generation and EvalKitti together,
    dispatches, launches, ALE/ALP); the three trees hold the same files,
    rows and detections, int8 and bf16 distances within 0.02 mean relative
    of float32's. The int8 run is under torch.profiler for the device's
    busy share. Then MonStereo (phase 9's weights, `--mode stereo`) over the
    same 1000 pairs at float32 and int8: distances within the dyn8 budget
    where both chose the same right pose (GenerateKitti's `aux_idx`), the
    share that did not printed.
 19. dyn8 and K1-bf16 against their plain versions (PERF.md section 2's
    rules) on the padded K^-1 rows of phase 18's 64-image chunk with the
    most detections an image, and their times there beside the f32 MLP's.
 20. The int8 and bf16 end-metric A/B: `tools.eval_parity` (three
    interpreters, float32, int8, bf16) on the JAX-trained byte-compat
    checkpoint (hidden 128, trained on easy-mode seed 11) over an easy-mode
    root of seed 12, 1000 val scenes (3769 before phases 24-28; phase 26
    holds the same A/B at full volume on a checkpoint trained on the
    card): int8 and bf16 ALE (all) within 2% of
    float32's, each ALP gate within 1 point, every chunk through its kernel.
 21. Prep through the entry point: `run prep` on a hard-mode synthetic KITTI
    tree (600 train + 300 val scenes, seed 21, cut from 1000 train to make
    room for phases 24-28; images written, so image
    sizes come from the PNG headers), mono and stereo; the wall, rows per
    phase and file sizes printed, every row's inputs its keypoints through
    K^-1.
 22. Training on the card at MonoLoco++'s full width (hidden 1024, 3
    stages, bs 512, dropout 0.2). First the card against the CPU from the
    same weights, on the same rows with the keep-masks the card drew: 10
    steps each free-running (the deviation printed: Adam turns last-bit
    differences of near-zero gradients into lr-sized moves, so the two
    trajectories part), then 10 steps with each CPU step taken from the
    card's state before it (weights, BN statistics, Adam moments and
    count), losses and gradient norms (before clipping) within 1e-4
    relative. Then `run train` for 10 epochs at float32, tensorfloat32 and
    bf16, and MonStereo (68 -> 10) for 3 at float32 (cut from 30 and 5 to
    make room for phases 24-28): steps/s, samples/s, an
    epoch's wall, the device's busy share of one epoch (torch.profiler);
    the val d loss must fall from epoch 0 to the best epoch, and no serving
    kernel launches.
 23. The float32 checkpoint of phase 22 through `eval --generate` and
    EvalKitti on the tree's 300 val scenes: ALE/ALP printed, not bounded,
    as the entry point scores and with every detection kept.
 24. `run train --resume` at full width (hidden 1024, bs 512) on phase 21's
    mono joints: 6 epochs straight against 3, then a resume for 3 more,
    the final train and val losses within 1e-4 (rtol and atol) and the
    best epoch equal (the largest differences printed); a zero-epoch
    resume keeps the best weights bit for bit and the meta's epoch. The
    straight run's checkpoint serves phase 28.
 25. `run train --hyp` at the real search space (hidden 512/1024/2048, bs
    64-1024, 3 stages), multiplier 3 (18 trials), 2 epochs a trial,
    serial then stacked (MONOLOCO_TPU_HYP_PARALLEL=1): group sizes, walls,
    each trial's best val d on both paths. Trials of a group of one equal
    their serial runs; the stacked trials part from theirs after a few
    steps, as the card and the CPU do (phase 22), so the largest group's
    first 5 stacked steps are each held against its trials' own Trainers
    from the stacked state: losses and gradient norms within 1e-4
    relative, the clipped gradients within 1e-5 of their norm, the
    weights after the update within 2 lr.
 26. `tools.eval_parity --train` as a user runs it (stages and legs in
    subprocesses): the hard synthetic KITTI of the JAX head-to-head
    (dataset seed 7, 2400 + 2400 scenes), prep, 500 epochs of training at
    the reference's configuration on the card, generation and EvalKitti
    at float32, int8 and bf16. The float32 leg within 3% of the JAX
    package's ALE (all) 1.290 m, ALP <1m within 2 points of 42.38, and
    7253 matched rows; int8 and bf16 within 2% ALE and 1 point ALP of
    float32, every chunk through its kernel; the training wall, samples/s
    and the busy share of one epoch printed.
 27. The same path for stereo (dataset seed 8), cut to fit the time limit
    to 200 + 200 scenes, 5 epochs and the float32 leg: it runs on the
    card and scores finite ALE/ALP over matched rows. The full-volume
    stereo comparison (928 + 942 scenes, 500 epochs: within 5% of the JAX
    package's 0.761 m, 2 points of 56.44, exactly 2622 rows) is the tool's
    own run, `python -m monoloco_tpu_torch.tools.eval_parity ROOT --train
    --mode stereo`, recorded in PERF.md.
 28. The eval verticals through the entry point on phase 21's tree: `prep
    --activity`, then `eval --activity --dataset kitti` under int8 (dyn8
    on the frames of 9 or more detections); `eval --geometric` and `eval
    --variance`; `eval --generate --baselines` (mono) under int8 with a
    legacy checkpoint from `init_monoloco_params`, the three trees alike;
    `eval --save` (the JAX figure names where matplotlib is installed,
    else the exit naming it); `predict --webcam --output_types json` over
    8 frames on stub cv2 and openpifpaf, with `Loco` on the card under
    int8.
 29. ReID on the card: the ResNet-50 at 256x128 (weights from
    `init_resnet50`, seed 1) on 64 crops of the fixture pair, decoded,
    cropped and resized by the port's image module; the card's f32
    features against the CPU's within 1e-4 of the largest (TF32 off), ms a
    batch and crops/s (the net, and the forward with the host's resize);
    then the tiny fixture net on the same crops within 1e-5.
 30. `eval --generate --baselines --mode stereo` through the entry point on
    a synthetic tree of 64 scenes with identity-textured right images,
    MonStereo at full width (phase 9's weights, theta and psi biased to
    pi/2), the legacy MonoLoco net,
    the tiny ReID through `--reid_weights`: float32, int8 (dyn8 on every
    image's m x r pairings) and bf16 (K1-bf16), the five trees written;
    the monstereo tree equals a float32 run without --baselines row for
    row (one dispatch an image against 64-image chunks: files, rows, text
    and boxes equal, positions within 1e-5 (1 + |x|), every column's largest
    difference printed); int8
    and bf16 within the dyn8 budget of float32 on the reid and monstereo
    trees; the STEREO: correction percentages, dispatches, images/s.
 31. Meshes on the card, an NCCL world of torch.cuda.device_count() ranks
    (one on a one-card machine: dp1; NCCL takes one rank a card, so the
    equalities of several ranks are the CPU tests' over gloo): `run train
    --dp_devices N` for 2 epochs (val losses against a run without a mesh,
    bit equal on one card), `eval --generate --dp_devices N` mono and
    stereo at float32 and int8 (txts byte-equal to the run without a
    mesh), `serve --dp_devices N` (8 requests within 1e-5 (1 + |ref|) of
    the meshless engine), `dryrun_multichip(N)` at flagship shapes; with
    four cards or more also `run train` at dp2 x tp2.
The launch counts of the report are those of the main-path runs (phases 4,
8, 9, 11, 12, 13, 16, 17, 18, 20, 26-28, 30 and 31, each with every count set to 0
just before it; phases 20, 26 and 27 from their legs' own processes); a
count is one
call of the kernel's entry, which makes 2S + 4 CUDA launches for K1-bf16,
2S + 5 for K5, K1-f32 and K4, 4S + 7 for dyn8 and 8 for K6. Each report
entry has its time, its plain version's, the bound (the larger of its
operations over the card's peak for their type and its bytes over 3.35
TB/s, from this run's shapes) and `library_ms`, the `torch.matmul` MLP of
the same weight type where there is one (for K6 the `torch.matmul` chain).
K1-f32's operations are counted three times at the TF32
tensor-core peak: the least time in which this card computes an
f32-accurate product is 3xTF32 on the tensor cores, not one pass on the
CUDA cores (67 TFLOP/s). The line before the last is the kernel report
(JSON); the last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HIDDEN, STAGES, IN_DIM, OUT_DIM = 1024, 3, 34, 9
M_ROWS = (1, 77, 512, 4096, 131072)
TIMING_ROWS = 131072
SEED = 0
D_CHANNEL = 2              # raw output channel of the distance mean

# Kernel vs plain: both quantize identically; they differ only in the order
# of the f32 sums of the bf16 layers (l0 over 34 terms, the heads over 1024),
# and a last-ulp difference there can move an activation across a rounding
# tie of the next quantization, one int8 step. So the mean error is held
# tightly and the max loosely.
TOL_MEAN_REL = 1e-4        # mean|kernel - plain| / mean|plain|
TOL_MAX_ABS = 5e-2         # max|kernel - plain|, outputs are O(1)-O(10)
DYN8_BUDGET = 0.02         # dds_pred mean relative deviation int8 vs f32
BYTE_COMPAT_TOL = 1e-4     # 1e-3 for confs (tests/test_byte_compat.py)
# Phase 7, kernel vs plain (the rules of tests/test_torch_kernels_cuda.py):
#  int8 activations (K4): as dyn8's test, <= 10% of the rows with an output
#    off by more than 1e-5 (1 + |ref|), max abs 5e-2, mean <= 1e-3 of the
#    mean output;
#  bf16 activations (K1-bf16, K5): each layer rounds its input to bf16, and
#    the tensor cores' f32 sums differ from the plain version's exact ones
#    in the last bits, so roundings flip in most rows: max abs 5e-2, mean
#    <= 5e-3 of the mean output, and no further from the f32 MLP than 1.25x
#    the plain version (m >= 512);
#  f32 weights (K1-f32): max abs 1e-4 (3xTF32 products, which drop
#    a_small w_small, summed by the tensor cores in their own order).
F32_TOL_MAX_ABS = 1e-4
BF16_TOL_MEAN_REL = 5e-3
BF16_VS_F32 = 1.25
# One layer of csrc/wgmma_layer.cu against its plain layer: the bf16 rule,
# and since only one f32 sum's order differs, at most LAYER_TOL_OFF of the
# bf16 outputs differ at all and the f32 residual stays within 1e-5 (1 + |y|).
LAYER_TOL_OFF = 0.01
# One 3xTF32 layer against its plain layer: within F32_LAYER_TOL (1 + |ref|).
F32_LAYER_TOL = 1e-5
PREDICT_IMAGES = 64        # phase 4: 64 copies of the fixture x 16 detections
PREDICT_ROWS = 1024        # the predict dispatch of phase 4
STEREO_IN, STEREO_OUT = 68, 10     # MonStereo
STEREO_PAIRS = 64          # phase 9: 64 pairs x 16 x 16 poses, one 16384-row dispatch
STEREO_PAIRINGS = ((7, 11), (32, 32), (128, 128))   # phase 10: 77, 1024, 16384 rows
CHAIN_LAYERS = 8           # K6, the roofline tool's relu chain
MC_DROPOUT = 10            # phases 12-13: MC passes, 10 x 1024 rows a dispatch
MC_FLAGS = ('--n_dropout', str(MC_DROPOUT), '--activities', 'social_distance', 'raise_hand')
ACTIVITY_ARGS = argparse.Namespace(threshold_prob=0.25, threshold_dist=2.5,
                                   radii=(0.3, 0.5, 1))      # the CLI's defaults
MC_TOL = 1e-4              # card epi vs the CPU's recomputation, max relative
BF16_BUDGET = 0.02         # bf16 dds_pred vs float32, mean relative
SERVE_IM_SIZE = (1238, 374)        # phases 15-16: the fixture as a serve request
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_DETS = 64, 8, 16
CROSSOVER_ROWS = '16,32,64,128,256,512,1024,2048,8192,131072'
GEN_TRAIN, GEN_VAL = 16, 1000      # phases 18-20 (KITTI's validation split is 3769 scenes)
GEN_CHUNK = 64                     # GenerateKitti's images a dispatch
GEN_PRECISIONS = ('float32', 'int8', 'bf16')
AB_SEED = 12               # phase 20's dataset; the checkpoint was trained on seed 11
AB_ALE_PCT = 2.0           # phase 20: int8 and bf16 ALE (all) within 2% of float32's,
AB_ALP_POINTS = 1.0        # and each ALP gate within 1 point
PREP_TRAIN, PREP_VAL, PREP_SEED = 600, 300, 21     # phase 21's synthetic tree, hard mode
TRAIN_BS, TRAIN_DROPOUT = 512, 0.2                  # phase 22: MonoLoco++'s training defaults
PARITY_STEPS = 10
TRAIN_PARITY_TOL = 1e-4    # card vs CPU, loss and gradient norm a step, relative
TRAIN_PRECISIONS = ('float32', 'tensorfloat32', 'bf16')
TRAIN_EPOCHS, STEREO_TRAIN_EPOCHS = 10, 3       # phase 22, cut to fit phases 24-28
RESUME_EPOCHS = 3          # phase 24: 2 x 3 straight against 3 + resume 3
RESUME_TOL = 1e-4          # phase 24: final val losses, rtol and atol (tests/test_extras.py)
HYP_MULTIPLIER, HYP_EPOCHS, HYP_SEED = 3, 2, 1      # phase 25: 18 trials, 2 epochs each
HYP_SYNC_STEPS = 5         # phase 25: stacked steps each checked against the trials' own
HYP_STEP_TOL = 1e-4        # phase 25: a step's loss and gradient norm, relative (phase 22's)
HYP_GRAD_TOL = 1e-5        # phase 25: a step's clipped gradients, of their global norm
FULL_ALE_PCT = {'mono': 3.0, 'stereo': 5.0}   # phases 26-27: float32 ALE (all) vs the JAX mean
FULL_ALP_POINTS = 2.0      # phases 26-27: ALP <1m vs the JAX mean
FULL_EPOCHS = {'mono': 500, 'stereo': 5}       # stereo cut to fit the time limit (phase 27)
STEREO_SMOKE_SCENES = 200       # phase 27: train and val scenes each
WEBCAM_FRAMES = 8          # phase 28

# Peaks of one H100 SXM (NVIDIA's data sheet, dense) for the bound.
PEAK_OPS = {'bf16': 989e12, 'tf32': 495e12, 'int8': 1979e12}
PEAK_BYTES = 3.35e12

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, 'tests', 'fixture_002282.png')
GOLD = os.path.join(REPO, 'tests', 'goldens', 'byte_compat')


_T0 = time.perf_counter()


def banner(text, **_):
    """A phase's first line, with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {text}", flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def smi_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def make_weights(in_dim=IN_DIM, out_dim=OUT_DIM, seed=SEED):
    """Loco params from `seed` at full width (MonoLoco++ 34 -> 9 by default,
    MonStereo 68 -> 10), with BN statistics and affine perturbed so that the
    fold is not the identity."""
    from monoloco_tpu_torch.models import init_loco_params
    params, bn_state = init_loco_params(seed, in_dim, out_dim, HIDDEN, STAGES)
    rng = np.random.default_rng(seed + 1)

    def perturb(p, s):
        shape = tuple(s['mean'].shape)
        s['mean'] = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
        s['var'] = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        p['scale'] = torch.from_numpy(rng.uniform(0.8, 1.2, shape).astype(np.float32))
        p['bias'] = torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32))

    perturb(params['bn1'], bn_state['bn1'])
    perturb(params['bn3'], bn_state['bn3'])
    for k in ('bn1', 'bn2'):
        perturb(params['stages'][k], bn_state['stages'][k])
    # Random weights predict distances of a few centimetres, where a relative
    # budget on dds_pred measures noise; a trained net predicts metres. So
    # the distance channel's output bias sits at a KITTI-like 15 m. The
    # int8-vs-f32 difference itself comes from the layers before it.
    params['w_fin']['b'][D_CHANNEL] += 15.0
    return params, bn_state


def make_poses(m, seed):
    """(m, 3, 17) pifpaf-like keypoints over a KITTI image, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    centre = torch.rand((m, 2, 1), generator=gen) * torch.tensor([[1238.], [374.]])
    spread = torch.rand((m, 2, 17), generator=gen) * torch.tensor([[60.], [160.]])
    return torch.cat([centre + spread - spread.mean(2, keepdim=True),
                      torch.rand((m, 1, 17), generator=gen)], dim=1)


def _kitti_kk(device):
    from monoloco_tpu_torch.network import load_calibration
    return torch.tensor(load_calibration('kitti', (1238, 374)), device=device)


def make_inputs(m, device):
    """(m, 34) MLP inputs the way the main path makes them: pifpaf-like
    keypoints over a KITTI image, K^-1-normalized at z=10."""
    from monoloco_tpu_torch.network import preprocess_monoloco
    return preprocess_monoloco(make_poses(m, SEED + m).to(device), _kitti_kk(device)).contiguous()


def make_pairing_inputs(m, r, device):
    """(m * r, 68) MonStereo inputs the way the stereo path makes them: m
    left and r right pifpaf-like poses paired all against all by
    `preprocess_monstereo`."""
    from monoloco_tpu_torch.network import preprocess_monstereo
    inputs, _ = preprocess_monstereo(make_poses(m, SEED + m).to(device),
                                     make_poses(r, SEED + 7 * r + 1).to(device),
                                     _kitti_kk(device))
    return inputs.contiguous()


def phase_device():
    banner("== phase 1: device", flush=True)
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    from monoloco_tpu_torch.ops import _build
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"kernel library {os.path.relpath(info['path'], REPO)} built/loaded in "
          f"{info['seconds']:.2f} s")
    for line in info['nvcc_output'].splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line.lower():
            print(f"  nvcc: {line.strip()}")
    return smi


def phase_kernel(packed, ms):
    from monoloco_tpu_torch.ops import dyn8_forward_plain, fused_loco_forward_dyn8_auto, launches
    banner(f"== phase 2: kernel vs plain, hidden {HIDDEN}, {STAGES} stages "
          f"(tolerance: mean rel {TOL_MEAN_REL}, max abs {TOL_MAX_ABS})", flush=True)
    worst = 0.0
    for m in ms:
        x = make_inputs(m, 'cuda')
        before = launches['dyn8_mlp']
        out_k = fused_loco_forward_dyn8_auto(packed, x)
        torch.cuda.synchronize()
        check(launches['dyn8_mlp'] == before + 1, "kernel launch counter did not rise")
        out_p = dyn8_forward_plain(packed, x)
        check(out_k.shape == (m, OUT_DIM), f"kernel output shape {tuple(out_k.shape)}")
        check(bool(torch.isfinite(out_k).all()), f"non-finite kernel output at m={m}")
        diff = (out_k - out_p).abs()
        max_abs = float(diff.max())
        mean_rel = float(diff.mean() / out_p.abs().mean())
        n_off = int((diff > 1e-5).sum())
        print(f"m={m:6d}: max_abs_err {max_abs:.3e}  mean_rel_err {mean_rel:.3e}  "
              f"elements >1e-5: {n_off}/{diff.numel()}", flush=True)
        check(max_abs <= TOL_MAX_ABS and mean_rel <= TOL_MEAN_REL,
              f"kernel disagrees with the plain version at m={m}")
        worst = max(worst, max_abs)
    return worst


def phase_rows(packed):
    from monoloco_tpu_torch.ops import fused_loco_forward_dyn8_auto
    banner("== phase 3: row independence", flush=True)
    x = make_inputs(512, 'cuda')
    full = fused_loco_forward_dyn8_auto(packed, x)
    for m in (1, 8, 77, 512):
        part = fused_loco_forward_dyn8_auto(packed, x[:m].contiguous())
        check(torch.equal(part, full[:m]), f"kernel(x[:{m}]) != kernel(x)[:{m}]")
        print(f"m={m}: bit-equal")


def _zero_launches():
    from monoloco_tpu_torch.ops import launches
    for key in launches:
        launches[key] = 0


def _run_predict(precision, model, img_dir, out_dir, mode='mono', extra=()):
    """The predict CLI over img_dir's PNGs, with every launch count set to 0
    just before; returns (the engine, the dyn8 launches of the run)."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.ops import launches
    os.environ['MONOLOCO_TPU_PRECISION'] = precision
    _zero_launches()
    net = run.main(['predict', '--glob', os.path.join(img_dir, '*.png'), '--mode', mode,
                    '--model', model, '--calibration', 'kitti',
                    '--output_types', 'json', '-o', out_dir, *extra])
    torch.cuda.synchronize()
    return net, launches['dyn8_mlp']


def _read_outputs(out_dir, n, keys=('dds_pred', 'stds_ale', 'confs', 'xyz_pred', 'angles')):
    """{key: values of every detection, file by file in name order} of the
    n .monoloco.json files in out_dir; each key finite and non-empty."""
    files = sorted(f for f in os.listdir(out_dir) if f.endswith('.monoloco.json'))
    check(len(files) == n, f"{len(files)} .monoloco.json files in {out_dir}, expected {n}")
    out = {key: [] for key in keys}
    for f in files:
        with open(os.path.join(out_dir, f)) as fh:
            dic = json.load(fh)
        for key in keys:
            vals = np.asarray(dic[key], np.float64)
            check(vals.size > 0 and np.isfinite(vals).all(), f"{f}: bad {key}")
            out[key].append(vals)
    return {key: np.concatenate(v) for key, v in out.items()}


def _read_dicts(out_dir, n):
    """The n .monoloco.json dicts of out_dir, in file name order."""
    files = sorted(f for f in os.listdir(out_dir) if f.endswith('.monoloco.json'))
    check(len(files) == n, f"{len(files)} .monoloco.json files in {out_dir}, expected {n}")
    dicts = []
    for f in files:
        with open(os.path.join(out_dir, f)) as fh:
            dicts.append(json.load(fh))
    return dicts


def _main_model(tmp):
    return os.path.join(tmp, f'loco_h{HIDDEN}.pkl')


def phase_main_path(params, bn_state, tmp):
    from monoloco_tpu_torch.models import save_checkpoint
    banner("== phase 4: main path, python -m monoloco_tpu_torch.run predict", flush=True)
    model = _main_model(tmp)
    save_checkpoint(model, params, bn_state, meta={'seed': SEED})
    img_dir = os.path.join(tmp, 'images')
    os.makedirs(img_dir)
    for i in range(PREDICT_IMAGES):
        dst = os.path.join(img_dir, f'im{i:03d}.png')
        shutil.copy(FIXTURE, dst)
        shutil.copy(os.path.join(REPO, 'tests', 'fixture_002282.pifpaf.json'),
                    dst + '.pifpaf.json')
    t0 = time.perf_counter()
    net, n_launch = _run_predict('int8', model, img_dir, os.path.join(tmp, 'out_int8'))
    wall = time.perf_counter() - t0
    print(f"int8 run: {wall:.2f} s wall, dispatches {net.n_dispatches}, "
          f"int8 dispatches {net.n_dispatches_int8}, dyn8 kernel launches {n_launch}",
          flush=True)
    check(net.n_dispatches_int8 > 0, "no dispatch routed to int8")
    check(n_launch > 0, "the main path never launched the dyn8 kernel")
    d8 = _read_outputs(os.path.join(tmp, 'out_int8'), PREDICT_IMAGES)['dds_pred']
    net32, n32 = _run_predict('float32', model, img_dir, os.path.join(tmp, 'out_f32'))
    check(net32.n_dispatches_int8 == 0 and n32 == 0, "float32 run touched the kernel")
    d32 = _read_outputs(os.path.join(tmp, 'out_f32'), PREDICT_IMAGES)['dds_pred']
    rel = float(np.abs(d8 - d32).mean() / np.abs(d32).mean())
    print(f"dds_pred int8 vs float32: mean relative deviation {rel:.3e} "
          f"(budget {DYN8_BUDGET}) over {d8.size} detections")
    check(rel < DYN8_BUDGET, "int8 dds_pred outside the dyn8 budget")
    return {'dyn8_mlp': n_launch}


def phase_reference():
    from monoloco_tpu_torch.network import Loco, load_calibration, preprocess_pifpaf
    banner("== phase 5: f32 engine vs the reference golden", flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    with open(os.path.join(GOLD, 'manifest.json')) as f:
        im_size = tuple(json.load(f)['im_size'])
    with open(os.path.join(REPO, 'tests', 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    kk = load_calibration('kitti', im_size)
    net = Loco(model=os.path.join(GOLD, 'model_tpu.pkl'), mode='mono', device='cuda')
    boxes, keypoints = preprocess_pifpaf(anns, im_size=im_size)
    ours = net.post_process(net.forward(keypoints, kk), boxes, keypoints, kk)
    with open(os.path.join(GOLD, 'out.monoloco.json')) as f:
        ref = json.load(f)
    check(set(ref) <= set(ours) and set(ours) - set(ref) <= {'indices'},
          f"key sets differ: {sorted(ours)} vs {sorted(ref)}")
    worst = 0.0
    for key, ref_v in ref.items():
        check(len(ours[key]) == len(ref_v), f"{key}: length differs")
        if key == 'gt':
            check(list(ours[key]) == list(ref_v), "gt differs")
            continue
        a = np.asarray(ours[key], np.float64)
        b = np.asarray(ref_v, np.float64)
        tol = 1e-3 if key == 'confs' else BYTE_COMPAT_TOL
        check(a.shape == b.shape and np.allclose(a, b, rtol=tol, atol=tol),
              f"{key} differs from the golden: max {np.max(np.abs(a - b)) if a.size else 0}")
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b))))
    print(f"all {len(ref)} keys within tolerance; max abs diff {worst:.3e}")


def _time_ms(fn, x):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


LAYERED = ('fused_mlp_bf16', 'fused_mlp_f32', 'dyn8_mlp', 'int8_static_mlp', 'w8_mlp')


def phase_times(kernels, folded, smi):
    from monoloco_tpu_torch.models import folded_forward
    from monoloco_tpu_torch.bench import tree_map
    banner(f"== phase 6: times at {TIMING_ROWS} x {IN_DIM} on {smi}", flush=True)
    x = make_inputs(TIMING_ROWS, 'cuda')
    folded_bf16 = tree_map(lambda t: t.to(torch.bfloat16), folded)
    paths = {'f32 folded (torch.matmul)': lambda v: folded_forward(folded, v),
             'bf16 folded (torch.matmul)':
                 lambda v: folded_forward(folded_bf16, v.to(torch.bfloat16)).float()}
    for name, (entry, plain, packed) in kernels.items():
        paths[f'{name} kernel'] = lambda v, e=entry, p=packed: e(p, v)
        paths[f'{name} plain'] = lambda v, f=plain, p=packed: f(p, v)
    times = {name: [] for name in paths}
    with torch.inference_mode():
        for fn in paths.values():          # warm-up
            for _ in range(2):
                fn(x)
        torch.cuda.synchronize()
        for _ in range(7):                  # in turns
            for name, fn in paths.items():
                times[name].append(_time_ms(fn, x))
    med = {name: statistics.median(v) for name, v in times.items()}
    for name, v in times.items():
        print(f"{name}: median {med[name]:.4f} ms over {len(v)} runs "
              f"(min {min(v):.4f}, max {max(v):.4f})")
    entry, plain, packed = kernels['dyn8_mlp']
    small = make_inputs(PREDICT_ROWS, 'cuda')
    with torch.inference_mode():
        for name, fn in (('kernel', entry), ('plain', plain)):
            for _ in range(3):
                fn(packed, small)
            v = [_time_ms(lambda u: fn(packed, u), small) for _ in range(21)]
            print(f"dyn8_mlp {name} at {PREDICT_ROWS} rows: median {statistics.median(v):.4f} ms "
                  f"over {len(v)} runs (min {min(v):.4f}, max {max(v):.4f})")
    med.update(time_relu_chain())
    breakdowns = {name: launch_breakdown(name, *kernels[name][::2], x,
                                         in_order=name in ('dyn8_mlp', 'int8_static_mlp'))
                  for name in LAYERED}
    int_mm_yardstick({name: breakdowns[name] for name in ('dyn8_mlp', 'int8_static_mlp')})
    for name in LAYERED:
        entry, _, packed = kernels[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = entry(packed, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"{name}: peak device memory of one call above its inputs "
              f"{peak / 2 ** 20:.1f} MiB ({peak} bytes, output included)")
        del out
    return med


def time_relu_chain():
    """K6 at 131072 x 1024 x 8 beside the path it ran on before (the
    wgmma_layer path: csrc/wgmma_layer.cu's relu layer with a zero bias),
    its plain version and the `torch.matmul` chain, median of 7 in turns;
    the launch-by-launch device time of the kernel and of the wgmma_layer
    path, and the kernel's peak memory. Returns the medians by name."""
    from monoloco_tpu_torch.ops import fused_mlp, relu_chain, relu_chain_plain
    from monoloco_tpu_torch.tools.bench_roofline import relu_chain_library
    x, ws = relu_chain_inputs()
    paths = {'relu_chain_bf16 kernel': lambda v: relu_chain(v, ws),
             'relu_chain_bf16 wgmma_layer path':
                 lambda v: fused_mlp._relu_chain_wgmma_layer(v, ws),
             'relu_chain_bf16 plain': lambda v: relu_chain_plain(v, ws),
             'relu chain (torch.matmul)': lambda v: relu_chain_library(v, ws)}
    times = {name: [] for name in paths}
    with torch.inference_mode():
        for fn in paths.values():
            for _ in range(2):
                fn(x)
        torch.cuda.synchronize()
        for _ in range(7):
            for name, fn in paths.items():
                times[name].append(_time_ms(fn, x))
    med = {name: statistics.median(v) for name, v in times.items()}
    for name, v in times.items():
        print(f"{name} at {TIMING_ROWS} x {HIDDEN} x {CHAIN_LAYERS}: median {med[name]:.4f} ms "
              f"over {len(v)} runs (min {min(v):.4f}, max {max(v):.4f})")
    launch_breakdown('relu_chain_bf16', lambda p, v: relu_chain(v, p), ws, x, in_order=True)
    launch_breakdown('relu_chain_bf16 wgmma_layer path',
                     lambda p, v: fused_mlp._relu_chain_wgmma_layer(v, p), ws, x, in_order=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = relu_chain(x, ws)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"relu_chain_bf16: peak device memory of one call above its inputs "
          f"{peak / 2 ** 20:.1f} MiB ({peak} bytes, output included)")
    del out
    return med


def chain_bound(m):
    """(ms, 'bytes' or 'operations') for K6 on m rows: its bf16 products over
    the bf16 peak, or x and y (bf16, once each) and the weights over the
    memory rate."""
    ops = 2 * m * HIDDEN * HIDDEN * CHAIN_LAYERS
    nbytes = 2 * m * HIDDEN * 2 + CHAIN_LAYERS * HIDDEN * HIDDEN * 2
    t_ops, t_bytes = ops / PEAK_OPS['bf16'], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def launch_breakdown(name, entry, packed, x, in_order=False):
    """Device time of each CUDA kernel in one call, from torch.profiler:
    printed by kernel (and with `in_order` launch by launch, in the order
    they ran), and returned as [(ms, launches, kernel name)]."""
    from torch.profiler import ProfilerActivity, profile
    entry(packed, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entry(packed, x)
        torch.cuda.synchronize()
    rows = [(getattr(e, 'device_time_total', 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    if not rows:
        print(f"{name}: launch breakdown not measured (the profiler saw no device time)")
        return rows
    print(f"{name}: device time of one call by kernel (torch.profiler), "
          f"{sum(r[0] for r in rows):.4f} ms in all")
    for ms, count, key in rows:
        print(f"  {ms:8.4f} ms  x{count:<3d} {key[:100]}")
    if in_order:
        launches = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3, e.name)
                          for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"{name}: launch by launch, in order: "
              + ", ".join(f"{ms:.4f}" for _, ms, _ in launches) + " ms")
    return rows


def int_mm_yardstick(breakdowns):
    """torch._int_mm (s8 x s8 -> s32), the one PyTorch call that computes an
    s8 layer's product, at TIMING_ROWS x HIDDEN x HIDDEN, beside the
    per-launch device time of each kernel's s8 layers (`breakdowns`: name
    -> launch_breakdown rows). It computes the product only, without the
    epilogue the layers fuse."""
    if not hasattr(torch, '_int_mm'):
        print("s8 layer yardstick: torch._int_mm is missing in this torch; not measured")
        return
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    q = torch.randint(-127, 128, (TIMING_ROWS, HIDDEN), dtype=torch.int8, device='cuda',
                      generator=gen)
    wt = torch.randint(-127, 128, (HIDDEN, HIDDEN), dtype=torch.int8, device='cuda',
                       generator=gen)
    ref = (q[:256].double() @ wt.double().T).to(torch.int32)
    check(torch.equal(torch._int_mm(q[:256], wt.T), ref), "torch._int_mm is not q @ wt^T")
    with torch.inference_mode():
        for _ in range(3):
            torch._int_mm(q, wt.T)
        v = [_time_ms(lambda _: torch._int_mm(q, wt.T), None) for _ in range(21)]
    n_ops = 2 * TIMING_ROWS * HIDDEN * HIDDEN
    nbytes = TIMING_ROWS * HIDDEN * (1 + 4) + HIDDEN * HIDDEN
    bound = max(n_ops / PEAK_OPS['int8'], nbytes / PEAK_BYTES) * 1e3
    print(f"s8 layer yardstick at {TIMING_ROWS} x {HIDDEN} x {HIDDEN}: torch._int_mm median "
          f"{statistics.median(v):.4f} ms over {len(v)} runs (min {min(v):.4f}, max "
          f"{max(v):.4f}); its bound {bound:.4f} ms (s32 out)")
    for name, rows in breakdowns.items():
        layers = [(ms, n) for ms, n, key in rows if 'layer_kernel' in key and 'S8' in key]
        if not layers:
            print(f"  {name} s8 layer: not measured (no profiler rows)")
            continue
        ms, n = sum(r[0] for r in layers), sum(r[1] for r in layers)
        print(f"  {name} s8 layer: {ms / n:.4f} ms per launch ({n} launches, {ms:.4f} ms)")


def bound(name, packed, m):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for one forward of m rows: operations over the peak of their type (for
    K1-f32 three TF32 passes, 3xTF32), bytes (x, out and the packed weights,
    each once) over the memory rate."""
    hidden, n_mm = packed[0].shape[1], packed[2].shape[0]
    op_type, passes = OP_TYPE[name]
    ops = passes * 2 * m * (IN_DIM * hidden + n_mm * hidden * hidden + hidden * OUT_DIM)
    nbytes = m * (IN_DIM + OUT_DIM) * 4 + sum(t.numel() * t.element_size() for t in packed)
    t_ops = ops / PEAK_OPS[op_type]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def _compare(name, rule, out, ref, f32_ref):
    """Hold a kernel's output against its plain version's; returns max abs."""
    diff = (out - ref).abs()
    max_abs = float(diff.max())
    mean_rel = float(diff.mean() / ref.abs().mean())
    rows_off = float((diff > 1e-5 * (1 + ref.abs())).any(dim=1).float().mean())
    line = (f"{name} m={out.shape[0]:6d} {out.shape[1]:2d} outs: max_abs_err {max_abs:.3e}  "
            f"mean_rel_err {mean_rel:.3e}  rows off {rows_off:.3f}")
    if rule == 'f32':
        ok = max_abs <= F32_TOL_MAX_ABS
    elif rule == 'int8':
        ok = max_abs <= TOL_MAX_ABS and rows_off <= 0.1 and mean_rel <= 1e-3
    else:
        ok = max_abs <= TOL_MAX_ABS and mean_rel <= BF16_TOL_MEAN_REL
        if out.shape[0] >= 512:
            k_err = float((out - f32_ref).abs().mean())
            p_err = float((ref - f32_ref).abs().mean())
            line += f"  vs f32: kernel {k_err:.3e}, plain {p_err:.3e}"
            ok = ok and k_err <= BF16_VS_F32 * p_err
    print(line, flush=True)
    check(ok and bool(torch.isfinite(out).all()),
          f"{name} disagrees with its plain version at m={out.shape[0]}")
    return max_abs


def phase_new_kernels(kernels, folded, stereo):
    from monoloco_tpu_torch.models import folded_forward
    from monoloco_tpu_torch.ops import launches
    banner(f"== phase 7: K1, K4, K5 and the layer kernels vs plain, hidden {HIDDEN}, "
          f"{STAGES} stages", flush=True)
    worst = {}
    for name, (entry, plain, packed) in kernels.items():
        if name == 'dyn8_mlp':
            continue
        rule = RULES[name]
        worst[name] = 0.0
        for m in M_ROWS:
            x = make_inputs(m, 'cuda')
            before = launches[name]
            out = entry(packed, x)
            torch.cuda.synchronize()
            check(launches[name] == before + 1, f"{name}: launch counter did not rise")
            check(out.shape == (m, OUT_DIM), f"{name}: output shape {tuple(out.shape)}")
            worst[name] = max(worst[name], _compare(name, rule, out, plain(packed, x),
                                                    folded_forward(folded, x)))
            del out
        s_entry, s_plain, s_packed, s_folded = stereo[name]
        xs = torch.from_numpy(np.random.default_rng(SEED + 77).normal(
            size=(77, 68)).astype(np.float32)).cuda()
        out = s_entry(s_packed, xs)
        check(out.shape == (77, 10), f"{name}: stereo output shape {tuple(out.shape)}")
        worst[name] = max(worst[name], _compare(f"{name} 68->10", rule, out,
                                                s_plain(s_packed, xs),
                                                folded_forward(s_folded, xs)))
        big = make_inputs(512, 'cuda')
        full = entry(packed, big)
        for m in (1, 8, 77, 512):
            check(torch.equal(entry(packed, big[:m].contiguous()), full[:m]),
                  f"{name}: kernel(x[:{m}]) != kernel(x)[:{m}]")
        print(f"{name}: rows bit-equal at m = 1, 8, 77, 512")
    phase_layers(kernels)
    return worst


def phase_layers(kernels):
    """One H x H layer of each layer kernel at 131072 x 1024 against its
    plain layer: csrc/wgmma_layer.cu per weight type and a 3xTF32 layer of
    csrc/wgmma_layer_kmajor.cu, each 'add_relu' (the epilogue that reads and
    writes the most); a dyn8 layer (row quantization + s8 layer) per
    epilogue, bit for bit against `_dynamic_layer` and its epilogue; and a
    static a8w8 layer per epilogue, bit for bit against
    `static_s8_layer_plain`, the next layer's int8 input included."""
    from monoloco_tpu_torch.ops import (f32_layer_plain, launches, layer_plain, loco_layer,
                                        loco_layer_dyn8, loco_layer_f32, loco_layer_static,
                                        quantize_static_plain, static_s8_layer_plain,
                                        transpose_int8_plain)
    from monoloco_tpu_torch.ops.fused_mlp import _dynamic_layer
    m = TIMING_ROWS
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    a32 = torch.randn((m, HIDDEN), device='cuda', generator=gen)
    a = a32.to(torch.bfloat16)
    y0 = torch.randn((m, HIDDEN), device='cuda', generator=gen)
    for key, pack_name, oscale_at in (('wgmma_layer_bf16', 'fused_mlp_bf16', None),
                                      ('wgmma_layer_w8', 'w8_mlp', 4)):
        packed = kernels[pack_name][2]
        w, bias = packed[2][1], (packed[5] if oscale_at else packed[3])[1]
        oscale = packed[oscale_at][1] if oscale_at else None
        y_k, y_p = y0.clone(), y0.clone()
        before = launches[key]
        out = loco_layer(a, w, bias, 'add_relu', oscale, y_k)
        torch.cuda.synchronize()
        check(launches[key] == before + 1, f"{key}: launch counter did not rise")
        ref = layer_plain(a, w, bias, 'add_relu', oscale, y_p)
        diff = (out.float() - ref.float()).abs()
        off = float((diff > 0).float().mean())
        y_err = float(((y_k - y_p).abs() / (1 + y_p.abs())).max())
        mean_rel = float(diff.mean() / ref.float().abs().mean())
        print(f"{key} m={m} x {HIDDEN}: max_abs_err {float(diff.max()):.3e}  mean_rel_err "
              f"{mean_rel:.3e}  outputs off {off:.5f}  residual err {y_err:.3e}", flush=True)
        check(off <= LAYER_TOL_OFF and y_err <= 1e-5 and float(diff.max()) <= TOL_MAX_ABS
              and mean_rel <= BF16_TOL_MEAN_REL, f"{key} disagrees with its plain layer")
        del out, ref, y_k, y_p

    f32_pack = kernels['fused_mlp_f32'][2]
    w_stack, b_stack = f32_pack[2], f32_pack[3]
    y_k, y_p = y0.clone(), y0.clone()
    before = launches['wgmma_layer_f32']
    out = loco_layer_f32(a32, w_stack[1], b_stack[1], 'add_relu', y_k)
    torch.cuda.synchronize()
    check(launches['wgmma_layer_f32'] == before + 1, "wgmma_layer_f32: counter did not rise")
    ref = f32_layer_plain(a32, w_stack[1], b_stack[1], 'add_relu', y_p)
    err = float(((out - ref).abs() / (1 + ref.abs())).max())
    print(f"wgmma_layer_f32 m={m} x {HIDDEN} add_relu: max err / (1 + |ref|) {err:.3e}  "
          f"max abs {float((out - ref).abs().max()):.3e}", flush=True)
    check(out is y_k and err <= F32_LAYER_TOL, "wgmma_layer_f32 disagrees with its plain layer")
    del out, ref, y_k, y_p

    w8 = kernels['dyn8_mlp'][2]
    wq, oscale, bias = w8[2][1], w8[4][1], w8[5][1]
    v = _dynamic_layer(a32, wq, oscale, bias)
    for epilogue, ref in (('store', v), ('relu', torch.relu(v)),
                          ('add_relu', y0 + torch.relu(v))):
        y_k = y0.clone()
        before = launches['wgmma_layer_dyn8']
        out, out_bf = loco_layer_dyn8(a32, wq, oscale, bias, epilogue, y_k)
        torch.cuda.synchronize()
        check(launches['wgmma_layer_dyn8'] == before + 1, "wgmma_layer_dyn8: counter did not rise")
        n_off = int((out != ref).sum())
        n_off_bf = int((out_bf != ref.to(torch.bfloat16)).sum())
        print(f"wgmma_layer_dyn8 m={m} x {HIDDEN} {epilogue}: f32 outputs off {n_off}, "
              f"bf16 outputs off {n_off_bf} (bit for bit: 0)", flush=True)
        check(n_off == 0 and n_off_bf == 0, f"wgmma_layer_dyn8 {epilogue} is not its plain layer")
        del out, out_bf, y_k

    a8 = kernels['int8_static_mlp'][2]
    wq, inv_in, oscale, bias = a8[2][1], a8[3], a8[4][1], a8[5][1]
    q = quantize_static_plain(a32, inv_in[1])
    wt = transpose_int8_plain(wq)
    for epilogue in ('store', 'relu', 'add_relu'):
        y_k, y_p = y0.clone(), y0.clone()
        before = launches['wgmma_layer_static']
        out, out_bf, q_next = loco_layer_static(q, wq, oscale, bias, epilogue, inv_in[2:3], y_k)
        torch.cuda.synchronize()
        check(launches['wgmma_layer_static'] == before + 1,
              "wgmma_layer_static: counter did not rise")
        ref, ref_bf, ref_q = static_s8_layer_plain(q, wt, oscale, bias, epilogue, inv_in[2:3], y_p)
        n_off = int((out != ref).sum())
        n_off_bf = int((out_bf != ref_bf).sum())
        n_off_q = int((q_next != ref_q).sum())
        clipped = float((ref_q.abs() == 127).float().mean())
        print(f"wgmma_layer_static m={m} x {HIDDEN} {epilogue}: f32 outputs off {n_off}, bf16 "
              f"off {n_off_bf}, next int8 input off {n_off_q} (bit for bit: 0; {clipped:.4f} "
              f"of it clipped)", flush=True)
        check(n_off == 0 and n_off_bf == 0 and n_off_q == 0 and torch.equal(y_k, y_p),
              f"wgmma_layer_static {epilogue} is not its plain layer")
        del out, out_bf, q_next, ref, ref_bf, ref_q, y_k, y_p


def phase_bench():
    """The bench and both tools, each JSON line checked; returns the launch
    counts of the whole phase."""
    from monoloco_tpu_torch import bench
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.tools import bench_pallas_crossover, bench_pallas_int8
    banner("== phase 8: python -m monoloco_tpu_torch.bench and the ablation tools",
          flush=True)
    _zero_launches()
    os.environ.pop('MONOLOCO_TPU_PRECISION', None)
    line = bench.main([])
    check(all(np.isfinite(v) for v in line['checksum'].values()), "bench: bad checksum")
    check('bf16_inferences_per_sec' in line and 'int8_dyn_inferences_per_sec' in line,
          "unpinned bench lacks a leg")
    check(line['launches']['int8'].get('dyn8_mlp', 0) > 0, "bench int8 leg: no dyn8 launch")
    for precision, kernel in (('int8-a8', 'int8_static_mlp'), ('int8-xla', None),
                              ('f32', None)):
        os.environ['MONOLOCO_TPU_PRECISION'] = precision
        line = bench.main([])
        check(np.isfinite(line['checksum']), f"bench {precision}: bad checksum")
        if kernel:
            check(line['launches'].get(kernel, 0) > 0, f"bench {precision}: no {kernel} launch")
        else:
            check(line['launches'] == {}, f"bench {precision} launched {line['launches']}")
    os.environ.pop('MONOLOCO_TPU_PRECISION', None)
    kernel_of = {'pallas-bf16': 'fused_mlp_bf16', 'pallas-f32': 'fused_mlp_f32',
                 'pallas-w8': 'w8_mlp', 'pallas-dyn8': 'dyn8_mlp',
                 'pallas-int8': 'int8_static_mlp'}
    records = bench_pallas_int8.main(list(bench_pallas_int8.VARIANTS) + ['pallas-f32'])
    check(len(records) == 7, f"bench_pallas_int8 printed {len(records)} records")
    for rec in records:
        check(np.isfinite(rec['checksum']), f"{rec['variant']}: bad checksum")
        kernel = kernel_of.get(rec['variant'])
        check((rec['launches'].get(kernel, 0) > 0) if kernel else rec['launches'] == {},
              f"{rec['variant']}: launches {rec['launches']}")
    before = launches['fused_mlp_bf16']
    records = bench_pallas_crossover.main(['--hiddens', '1024', '--batches', '256,131072'])
    check(len(records) == 4 and all('inf_per_sec' in r for r in records),
          "crossover records incomplete")
    check(launches['fused_mlp_bf16'] > before, "crossover: no K1-bf16 launch")
    return dict(launches)


def _stereo_pairs(img_dir):
    """STEREO_PAIRS (left, right) image pairs in img_dir: each left image the
    KITTI fixture with its 16 pifpaf poses, each right image a copy whose
    poses (keypoints and box) sit left by a disparity BF / z, z drawn per
    pose in 5-40 m from a seed."""
    from monoloco_tpu_torch.geometry import BF
    with open(os.path.join(REPO, 'tests', 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    rng = np.random.default_rng(SEED + 13)
    for i in range(STEREO_PAIRS):
        right = []
        for ann in anns:
            shift = BF / rng.uniform(5, 40)
            kps = list(ann['keypoints'])
            kps[0::3] = [x - shift for x in kps[0::3]]
            box = list(ann['bbox'])
            box[0] -= shift
            box[2] -= shift
            right.append({**ann, 'keypoints': kps, 'bbox': box})
        for side, poses in (('a', anns), ('b', right)):
            dst = os.path.join(img_dir, f'pair{i:03d}{side}.png')
            shutil.copy(FIXTURE, dst)
            with open(dst + '.pifpaf.json', 'w') as f:
                json.dump(poses, f)


def _stereo_rows(img_dir):
    """The rows of the stereo engine's one batched dispatch over img_dir's
    pairs, (STEREO_PAIRS * m * r, 68), made as predict and the engine make
    them: the poses as predict reads them, one batched pairing. Every image
    holds the fixture's 16 poses, so no pose or image is padding."""
    from monoloco_tpu_torch.network import (load_calibration, preprocess_monstereo,
                                            preprocess_pifpaf)
    from monoloco_tpu_torch.predict import image_size
    lefts, rights, kks = [], [], []
    for i in range(STEREO_PAIRS):
        path = os.path.join(img_dir, f'pair{i:03d}a.png')
        im_size = tuple(float(v) for v in image_size(path))
        for side, poses in (('a', lefts), ('b', rights)):
            with open(os.path.join(img_dir, f'pair{i:03d}{side}.png.pifpaf.json')) as f:
                poses.append(preprocess_pifpaf(json.load(f), im_size)[1])
        kks.append(load_calibration('kitti', im_size))
    dev = [torch.tensor(np.asarray(a, np.float32), device='cuda') for a in (lefts, rights, kks)]
    inputs, _ = preprocess_monstereo(*dev)
    return inputs.reshape(-1, STEREO_IN).contiguous(), len(lefts[0]), len(rights[0])


def phase_stereo(params, bn_state, tmp):
    """predict --mode stereo on STEREO_PAIRS pairs at int8 (one 16384-row
    dispatch, the dyn8 kernel) and at float32 (no launch). Each run's
    outputs are held against the rows recomputed outside the engine, and
    int8 against float32 where both chose the same right pose. Returns the
    launch counts of the int8 run."""
    from monoloco_tpu_torch.models import fold_eval_params, folded_forward, save_checkpoint
    from monoloco_tpu_torch.ops import fused_loco_forward_dyn8_auto, pack_folded_weights_w8
    banner(f"== phase 9: main path, python -m monoloco_tpu_torch.run predict --mode stereo, "
          f"{STEREO_PAIRS} pairs", flush=True)
    model = os.path.join(tmp, f'monstereo_h{HIDDEN}.pkl')
    save_checkpoint(model, params, bn_state, meta={'seed': SEED + 2})
    img_dir = os.path.join(tmp, 'stereo_images')
    os.makedirs(img_dir)
    _stereo_pairs(img_dir)
    keys = ('dds_pred', 'stds_ale', 'confs', 'xyz_pred', 'angles', 'aux')
    outs, n_launch = {}, {}
    for precision in ('int8', 'float32'):
        out_dir = os.path.join(tmp, f'stereo_{precision}')
        t0 = time.perf_counter()
        net, n_launch[precision] = _run_predict(precision, model, img_dir, out_dir,
                                                mode='stereo')
        print(f"{precision} run: {time.perf_counter() - t0:.2f} s wall, dispatches "
              f"{net.n_dispatches}, int8 dispatches {net.n_dispatches_int8}, dyn8 kernel "
              f"launches {n_launch[precision]}", flush=True)
        if precision == 'int8':
            check(net.n_dispatches_int8 > 0, "no stereo dispatch routed to int8")
            check(n_launch[precision] > 0, "the stereo path never launched the dyn8 kernel")
        else:
            check(net.n_dispatches_int8 == 0 and n_launch[precision] == 0,
                  "the float32 stereo run touched the kernel")
        outs[precision] = _read_outputs(out_dir, STEREO_PAIRS, keys)
    # The right pose each left pose chose: the argmax of the aux logit over
    # the same pairing rows, recomputed here (no row depends on the rows
    # around it, in either path).
    rows, m, r = _stereo_rows(img_dir)
    folded = _to_cuda(fold_eval_params(params, bn_state))
    raw = {'int8': fused_loco_forward_dyn8_auto(pack_folded_weights_w8(folded), rows),
           'float32': folded_forward(folded, rows)}
    chosen = {}
    for precision, v in raw.items():
        v = v.reshape(STEREO_PAIRS, m, r, STEREO_OUT)
        chosen[precision] = torch.argmax(v[..., -1], dim=2)
        picked = torch.take_along_dim(v, chosen[precision][..., None, None], dim=2)
        picked = picked.reshape(-1, STEREO_OUT).double().cpu()
        err = max(float((torch.from_numpy(outs[precision]['dds_pred'])
                         - picked[:, D_CHANNEL]).abs().max()),
                  float((torch.from_numpy(outs[precision]['aux'])
                         - torch.sigmoid(picked[:, -1])).abs().max()))
        print(f"{precision}: the CLI's dds_pred and aux against the recomputed choice: max abs "
              f"diff {err:.3e}")
        check(err <= 1e-4, f"{precision} stereo outputs are not the rows the engine chose")
    same = (chosen['int8'] == chosen['float32']).reshape(-1).cpu().numpy()
    d8, d32 = outs['int8']['dds_pred'], outs['float32']['dds_pred']
    rel_all = float(np.abs(d8 - d32).mean() / np.abs(d32).mean())
    check(same.any(), "int8 and float32 never choose the same right pose")
    rel = float(np.abs(d8 - d32)[same].mean() / np.abs(d32[same]).mean())
    print(f"stereo dds_pred int8 vs float32 over {d8.size} detections ({m} x {r} pairings an "
          f"image): right pose chosen differently for {int((~same).sum())} "
          f"({float((~same).mean()):.4f}); mean relative deviation {rel:.3e} where the choice "
          f"agrees (budget {DYN8_BUDGET}), {rel_all:.3e} over all")
    check(rel < DYN8_BUDGET, "int8 stereo dds_pred outside the dyn8 budget")
    return {'dyn8_mlp': n_launch['int8']}


def phase_dyn8_stereo(s_packed, s_folded):
    """dyn8 at MonStereo's widths, 68 -> 10, hidden 1024, on pairing rows,
    against its plain version under the int8 rule, and row independence."""
    from monoloco_tpu_torch.models import folded_forward
    from monoloco_tpu_torch.ops import dyn8_forward_plain, fused_loco_forward_dyn8_auto, launches
    banner(f"== phase 10: dyn8 vs plain at 68 -> 10, hidden {HIDDEN}, {STAGES} stages, on "
          f"stereo pairing rows", flush=True)
    worst = 0.0
    for m, r in STEREO_PAIRINGS:
        x = make_pairing_inputs(m, r, 'cuda')
        before = launches['dyn8_mlp']
        out = fused_loco_forward_dyn8_auto(s_packed, x)
        torch.cuda.synchronize()
        check(launches['dyn8_mlp'] == before + 1, "dyn8 68->10: launch counter did not rise")
        check(out.shape == (m * r, STEREO_OUT), f"dyn8 68->10: output shape {tuple(out.shape)}")
        worst = max(worst, _compare(f"dyn8_mlp 68->10 ({m} x {r})", 'int8', out,
                                    dyn8_forward_plain(s_packed, x), folded_forward(s_folded, x)))
    for n in (1, 8, 77, 1024):
        check(torch.equal(fused_loco_forward_dyn8_auto(s_packed, x[:n].contiguous()), out[:n]),
              f"dyn8 68->10: kernel(x[:{n}]) != kernel(x)[:{n}]")
    print("dyn8_mlp 68->10: rows bit-equal at m = 1, 8, 77, 1024")
    return worst


def relu_chain_inputs():
    """K6's operands at its tool's shape, 131072 x 1024 x 8, bf16 on the
    card: x ~ N(0, 1), weights ~ N(0, 2 / H), so the activations stay O(1)
    through the chain (the tool's own 0.01 scale shrinks them 4x a layer)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 11)
    x = torch.randn((TIMING_ROWS, HIDDEN), device='cuda', generator=gen).to(torch.bfloat16)
    ws = [(torch.randn((HIDDEN, HIDDEN), device='cuda', generator=gen) * (2 / HIDDEN) ** 0.5)
          .to(torch.bfloat16) for _ in range(CHAIN_LAYERS)]
    return x, ws


def phase_relu_chain():
    """K6 (relu_chain, csrc/relu_chain.cu) against relu_chain_plain at
    131072 x 1024 x 8, under the bf16 rule scaled to the outputs: the
    chain's outputs reach about 7 (N(0, 2 / H) weights keep their second
    moment), where one bf16 ulp is 3e-2 and a flip or two reaches the rule's
    5e-2, so both are divided by the plain version's largest output first.
    The f32 chain (no bf16 rounding) is the third party. Then against the
    wgmma_layer path (csrc/wgmma_layer.cu's relu layer, the same wgmma
    shape and k order): bit for bit, or under the same rule with the difference printed,
    there and at m = 1, 127, 129, 257 (a row block without rows in the last
    cluster at 1 and 257); rows bit-equal at m = 512 and a ragged 131071.
    Returns the max abs error against the plain version, unscaled."""
    from monoloco_tpu_torch.ops import fused_mlp, launches, relu_chain, relu_chain_plain
    banner(f"== phase 7b: relu_chain (K6) vs plain at {TIMING_ROWS} x {HIDDEN} x {CHAIN_LAYERS}",
          flush=True)
    x, ws = relu_chain_inputs()
    before = launches['relu_chain_bf16']
    out = relu_chain(x, ws)
    torch.cuda.synchronize()
    check(launches['relu_chain_bf16'] == before + 1, "relu_chain: launch counter did not rise")
    check(out.shape == x.shape and out.dtype == torch.bfloat16, "relu_chain: output")
    f32 = x.float()
    for w in ws:
        f32 = torch.relu(f32 @ w.float())
    ref = relu_chain_plain(x, ws).float()
    scale = float(ref.abs().max())
    worst = float((out.float() - ref).abs().max())
    print(f"relu_chain_bf16: largest output {scale:.4e}, max abs err {worst:.4e} unscaled")
    _compare('relu_chain_bf16 / max|plain|', 'bf16', out.float() / scale, ref / scale,
             f32 / scale)
    for n in (TIMING_ROWS, 1, 127, 129, 257):
        xs = x[:n].contiguous()
        ours = out if n == TIMING_ROWS else relu_chain(xs, ws)
        old = fused_mlp._relu_chain_wgmma_layer(xs, ws)
        torch.cuda.synchronize()
        if torch.equal(ours, old):
            print(f"relu_chain_bf16 vs the wgmma_layer path at m = {n}: bit-equal")
            continue
        diff = (ours.float() - old.float()).abs()
        print(f"relu_chain_bf16 vs the wgmma_layer path at m = {n}: max abs "
              f"{float(diff.max()):.4e}, {float((diff > 0).float().mean()):.4%} of the outputs "
              "differ")
        plain = ref[:n] if n == TIMING_ROWS else relu_chain_plain(xs, ws).float()
        _compare(f'relu_chain_bf16 vs wgmma_layer / max|plain| m={n}', 'bf16',
                 ours.float() / scale, old.float() / scale, plain / scale)
    for n in (512, TIMING_ROWS - 1):
        check(torch.equal(relu_chain(x[:n].contiguous(), ws), out[:n]),
              f"relu_chain: rows depend on the batch (m = {n})")
    print(f"relu_chain_bf16: rows bit-equal at m = 512 and {TIMING_ROWS - 1}")
    return worst


def phase_roofline():
    """The roofline tool as a user runs it; returns its launch counts."""
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.tools import bench_roofline
    banner("== phase 11: python -m monoloco_tpu_torch.tools.bench_roofline", flush=True)
    _zero_launches()
    rows = bench_roofline.main([])
    torch.cuda.synchronize()
    check([r['which'] for r in rows] == ['peak_8192cubed_tflops', 'chain_xla_tflops',
                                         'chain_pallas_resident_tflops', 'serve_inf_per_sec'],
          "roofline rows incomplete")
    check(all(np.isfinite(r['checksum']) and np.isfinite(r['value']) for r in rows),
          "roofline: bad checksum")
    check(launches['relu_chain_bf16'] > 0, "roofline: relu_chain never launched")
    return dict(launches)


class _McSpy:
    """Within the block, records each MC dispatch of the engine: (the
    engine, its keypoints and calibrations on the card, the draws it used,
    the epi it returned)."""

    def __enter__(self):
        from monoloco_tpu_torch.network import Loco
        self.calls, self.real = [], Loco.mc_epistemic
        calls, real = self.calls, self.real

        def mc_epistemic(net, kps, kk, mc=None):
            epi = real(net, kps, kk, mc)
            calls.append((net, kps, kk, net.mc_last, epi))
            return epi

        Loco.mc_epistemic = mc_epistemic
        return self

    def __exit__(self, *exc):
        from monoloco_tpu_torch.network import Loco
        Loco.mc_epistemic = self.real


def _check_mc_outputs(out_dir, ref_dir, epi):
    """The JSON of an MC + activities run against the phase 4 run at the
    same precision (ref_dir): stds_epi finite, > 0 and the dispatch's epi
    (B, m) exactly; every other key of ref_dir bit for bit; social_distance
    and raising_hand equal to a host recomputation from the JSON. Returns
    (the dicts, the number of detections flagged by each rule)."""
    from monoloco_tpu_torch.activity import is_raising_hand
    from monoloco_tpu_torch.network import Loco
    dicts, refs = _read_dicts(out_dir, PREDICT_IMAGES), _read_dicts(ref_dir, PREDICT_IMAGES)
    epi = epi.cpu().numpy()
    flagged = [0, 0]
    for i, (dic, ref) in enumerate(zip(dicts, refs)):
        e = np.asarray(dic['stds_epi'], np.float64)
        check(e.size == len(ref['dds_pred']) and np.isfinite(e).all() and (e > 0).all(),
              f"{out_dir} image {i}: stds_epi not finite and > 0 for every detection")
        check(dic['stds_epi'] == epi[i, :e.size].tolist(),
              f"{out_dir} image {i}: stds_epi is not the MC dispatch's epi")
        for key in ref:
            check(key == 'stds_epi' or dic[key] == ref[key],
                  f"{out_dir} image {i}: {key} differs from the run without MC")
        sd = Loco.social_distance({k: dic[k] for k in ('angles', 'dds_pred', 'stds_ale',
                                                       'xyz_pred')}, ACTIVITY_ARGS)
        check(dic['social_distance'] == sd['social_distance'],
              f"{out_dir} image {i}: social_distance differs from its host recomputation")
        check(dic['raising_hand'] == [is_raising_hand(kp) for kp in dic['uv_kps']],
              f"{out_dir} image {i}: raising_hand differs from its host recomputation")
        flagged[0] += sum(dic['social_distance'])
        flagged[1] += sum(v is not None for v in dic['raising_hand'])
    return dicts, flagged


def _median_ms(fn, reps=7):
    """Median of `reps` CUDA-event times of fn() after two warm-up calls;
    returns (median, min, max)."""
    with torch.inference_mode():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        v = [_time_ms(lambda _: fn(), None) for _ in range(reps)]
    return statistics.median(v), min(v), max(v)


def phase_mc(tmp):
    """predict with MC dropout and both activities, at float32 and int8,
    against phase 4's runs; the card's epi against the CPU's recomputation
    from the card's own draws; one MC dispatch timed. Returns (the dicts and
    the epi of the float32 run, the launch counts of the int8 run)."""
    from monoloco_tpu_torch.network import Loco
    from monoloco_tpu_torch.ops import launches
    banner(f"== phase 12: main path with --n_dropout {MC_DROPOUT} --activities social_distance "
          f"raise_hand, {PREDICT_IMAGES} images", flush=True)
    model, img_dir = _main_model(tmp), os.path.join(tmp, 'images')
    epis = {}
    for precision, ref in (('float32', 'out_f32'), ('int8', 'out_int8')):
        out_dir = os.path.join(tmp, f'mc_{precision}')
        with _McSpy() as spy:
            t0 = time.perf_counter()
            net, n_dyn8 = _run_predict(precision, model, img_dir, out_dir, extra=MC_FLAGS)
            wall = time.perf_counter() - t0
        ran = {k: n for k, n in launches.items() if n}
        print(f"{precision} run: {wall:.2f} s wall, dispatches {net.n_dispatches}, MC "
              f"dispatches {len(spy.calls)}, kernel launches {ran}", flush=True)
        check(len(spy.calls) == 1 and net.n_dispatches == 1, "expected one main and one MC "
              f"dispatch for the {PREDICT_IMAGES} images")
        check(ran == ({'dyn8_mlp': 1} if precision == 'int8' else {}),
              f"{precision} MC run: launches {ran}")
        _, kps, kk, (masks, u), epi = spy.calls[0]
        check(masks[0].shape == (MC_DROPOUT, kps.shape[1], HIDDEN), "MC masks' shape")
        dicts, flagged = _check_mc_outputs(out_dir, os.path.join(tmp, ref), epi)
        print(f"{precision}: stds_epi of {sum(len(d['stds_epi']) for d in dicts)} detections "
              f"finite and > 0 (mean {float(epi.mean()):.4e} m); every other key equals phase 4 "
              f"bit for bit; social_distance flags {flagged[0]}, raised hands {flagged[1]}, "
              f"each equal to its host recomputation", flush=True)
        epis[precision] = epi
        if precision == 'float32':
            f32_dicts, f32_call = dicts, spy.calls[0]
        else:
            int8_counts = ran
    check(torch.equal(epis['int8'], epis['float32']),
          "MC under int8 is not the float32 MC (it must stay f32)")
    print("int8: epi equals float32's bit for bit (MC stays f32; the main dispatch ran dyn8)")

    net, kps, kk, (masks, u), epi = f32_call
    cpu = Loco(model=model, mode='mono', device='cpu', n_dropout=MC_DROPOUT)
    t0 = time.perf_counter()
    with torch.inference_mode():
        epi_cpu = cpu.mc_epistemic(kps.cpu(), kk.cpu(), ([m.cpu() for m in masks], u.cpu()))
    rel = float(((epi.cpu() - epi_cpu).abs() / epi_cpu.abs()).max())
    print(f"card epi against the CPU's plain f32 recomputation from the card's masks and "
          f"uniforms ({time.perf_counter() - t0:.1f} s on the CPU): max relative difference "
          f"{rel:.3e} (tolerance {MC_TOL})", flush=True)
    check(rel <= MC_TOL, "the card's epi disagrees with the CPU's recomputation")

    rows = MC_DROPOUT * kps.shape[0] * kps.shape[1]
    for what, fn in (('draws + forward', lambda: net.mc_epistemic(kps, kk)),
                     ('forward on given draws', lambda: net.mc_epistemic(kps, kk, (masks, u)))):
        med, lo, hi = _median_ms(fn)
        print(f"one MC dispatch ({what}), {MC_DROPOUT} passes x {kps.shape[0]} x "
              f"{kps.shape[1]} = {rows} rows at hidden {HIDDEN}, f32: median {med:.4f} ms over "
              f"7 runs (min {lo:.4f}, max {hi:.4f})")
    return f32_dicts, epis['float32'], int8_counts


def phase_precisions(tmp, f32_dicts, f32_epi, dyn8):
    """The same CLI run at bf16 (K1-bf16 on every dispatch, no dyn8) and
    tensorfloat32 (no kernel, TF32 around the MLP only), each against
    float32; K1-bf16 timed at the predict dispatch beside dyn8. Returns the
    launch counts of the bf16 run."""
    from monoloco_tpu_torch.ops import fused_loco_forward, launches
    banner(f"== phase 13: main path at bf16 and tensorfloat32, {PREDICT_IMAGES} images",
          flush=True)
    model, img_dir = _main_model(tmp), os.path.join(tmp, 'images')
    d32 = np.concatenate([d['dds_pred'] for d in f32_dicts])
    counts = {}
    for precision in ('bf16', 'tensorfloat32'):
        out_dir = os.path.join(tmp, f'mc_{precision}')
        with _McSpy() as spy:
            t0 = time.perf_counter()
            net, _ = _run_predict(precision, model, img_dir, out_dir, extra=MC_FLAGS)
            wall = time.perf_counter() - t0
        ran = {k: n for k, n in launches.items() if n}
        print(f"{precision} run: {wall:.2f} s wall, precision {net.precision}, kernel launches "
              f"{ran}", flush=True)
        if precision == 'bf16':
            check(ran.get('fused_mlp_bf16', 0) > 0 and 'dyn8_mlp' not in ran,
                  f"bf16 run: launches {ran}, expected fused_mlp_bf16 and no dyn8")
            counts = ran
            packed_bf16 = net.mlp_weights['packed_bf16']
        else:
            check(ran == {}, f"tensorfloat32 run launched {ran}")
            check(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 is on after the run")
        check(len(spy.calls) == 1 and torch.equal(spy.calls[0][4], f32_epi),
              f"{precision}: MC epi is not float32's (it must stay f32)")
        dicts = _read_dicts(out_dir, PREDICT_IMAGES)
        d = np.concatenate([x['dds_pred'] for x in dicts])
        check(np.isfinite(d).all() and d.shape == d32.shape, f"{precision}: bad dds_pred")
        rel = float(np.abs(d - d32).mean() / np.abs(d32).mean())
        print(f"{precision}: dds_pred against float32, mean relative deviation {rel:.3e} over "
              f"{d.size} detections (max abs {float(np.abs(d - d32).max()):.3e} m); epi equals "
              f"float32's bit for bit", flush=True)
        if precision == 'bf16':
            check(rel < BF16_BUDGET, f"bf16 dds_pred outside {BF16_BUDGET} of float32")
    x = make_inputs(PREDICT_ROWS, 'cuda')
    entry, _, packed = dyn8
    for name, fn in (('fused_mlp_bf16', lambda: fused_loco_forward(None, x, packed=packed_bf16)),
                     ('dyn8_mlp', lambda: entry(packed, x))):
        med, lo, hi = _median_ms(fn)
        print(f"{name} at {PREDICT_ROWS} rows (the predict dispatch): median {med:.4f} ms over "
              f"7 runs (min {lo:.4f}, max {hi:.4f})")
    return counts


def phase_keypoints_profile(tmp):
    """--mode keypoints builds no engine and launches nothing; a float32
    run under --profile gives the device's busy share of predict."""
    from monoloco_tpu_torch import predict, run
    from monoloco_tpu_torch.ops import launches
    banner("== phase 14: --mode keypoints, and predict under --profile", flush=True)
    img_dir = os.path.join(tmp, 'images')
    out_dir = os.path.join(tmp, 'keypoints')
    _zero_launches()
    real_loco = predict.Loco

    def no_engine(*args, **kwargs):
        fail("--mode keypoints built an engine")

    predict.Loco = no_engine
    try:
        net = run.main(['predict', '--glob', os.path.join(img_dir, '*.png'), '--mode',
                        'keypoints', '--output_types', 'json', '-o', out_dir])
    finally:
        predict.Loco = real_loco
    dicts = _read_dicts(out_dir, PREDICT_IMAGES)
    ran = {k: n for k, n in launches.items() if n}
    check(net is None and ran == {} and all(d == {} for d in dicts),
          f"--mode keypoints: engine {net}, launches {ran}")
    print(f"keypoints: {len(dicts)} JSON files, each {{}}; no engine, no launch")

    prof_dir = os.path.join(tmp, 'profile')
    _run_predict('float32', _main_model(tmp), img_dir, os.path.join(tmp, 'out_prof'),
                 extra=('--profile', prof_dir))
    with open(os.path.join(prof_dir, 'predict_trace.json')) as f:
        events = [e for e in json.load(f)['traceEvents'] if 'ts' in e and 'dur' in e]
    check(events, "the predict trace holds no events")
    wall = max(float(e['ts']) + float(e['dur']) for e in events) - min(float(e['ts'])
                                                                       for e in events)
    busy = {cat: sum(float(e['dur']) for e in events if e.get('cat') == cat)
            for cat in ('kernel', 'gpu_memcpy', 'gpu_memset')}
    n_kernels = sum(e.get('cat') == 'kernel' for e in events)
    check(n_kernels > 0, "the profiler saw no CUDA kernel in predict")
    print(f"predict float32 under --profile: {wall / 1e3:.2f} ms profiled wall, {n_kernels} CUDA "
          f"kernels, {busy['kernel'] / 1e3:.3f} ms of kernel time: device busy share "
          f"{busy['kernel'] / wall:.4%} (copies {busy['gpu_memcpy'] / 1e3:.3f} ms, memsets "
          f"{busy['gpu_memset'] / 1e3:.3f} ms)")


def _fixture_request():
    """The KITTI fixture as a serve request: its 16 poses (m, 3, 17), its
    boxes and K, as lists."""
    from monoloco_tpu_torch.network import load_calibration, preprocess_pifpaf
    with open(os.path.join(REPO, 'tests', 'fixture_002282.pifpaf.json')) as f:
        anns = json.load(f)
    boxes, keypoints = preprocess_pifpaf(anns, im_size=SERVE_IM_SIZE)
    return keypoints, boxes, load_calibration('kitti', SERVE_IM_SIZE)


def _fire_clients(port, payload, n_clients=SERVE_CLIENTS, n_requests=SERVE_REQUESTS):
    """n_clients concurrent keep-alive clients, each POSTing payload(client,
    i) n_requests times; every response must be 200. Returns [(client, i,
    response dict)]."""
    import http.client
    import threading
    out, errors, lock = [], [], threading.Lock()

    def client(c):
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
        try:
            for i in range(n_requests):
                conn.request('POST', '/v1/predict', body=json.dumps(payload(c, i)).encode(),
                             headers={'Content-Type': 'application/json'})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {body}")
                with lock:
                    out.append((c, i, body))
        except Exception as exc:  # noqa: BLE001 — every client's failure is reported
            with lock:
                errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors, f"{len(errors)} serve clients failed, first: {errors[:1]}")
    check(len(out) == n_clients * n_requests, f"{len(out)} responses")
    return out


def _get_json(port, path):
    import urllib.request
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}', timeout=30) as resp:
        return json.loads(resp.read())


def _rel_dev(responses, ref):
    """Mean relative deviation of every response's distance (xyzd[:, 3])
    from that of `ref`, one image's forward outputs."""
    d = np.concatenate([np.asarray(r['outputs']['xyzd'], np.float64)[:, 3]
                        for _, _, r in responses])
    ref = np.tile(np.asarray(ref['xyzd'], np.float64)[:, 3], len(responses))
    check(np.isfinite(d).all(), "non-finite distances in the responses")
    return float(np.abs(d - ref).mean() / np.abs(ref).mean())


def phase_serve_entry(tmp):
    """`python -m monoloco_tpu_torch.serve` under int8 on phase 4's
    checkpoint, as a user starts it: healthz, 64 keep-alive clients x 8
    requests of the fixture, metrics, every distance against an in-process
    float32 Loco, SIGTERM."""
    import re
    import signal
    import threading
    from monoloco_tpu_torch.network import Loco
    banner(f"== phase 15: python -m monoloco_tpu_torch.serve under int8, {SERVE_CLIENTS} clients "
          f"x {SERVE_REQUESTS} requests x {SERVE_DETS} detections", flush=True)
    model = _main_model(tmp)
    kps, boxes, kk = _fixture_request()
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    ref = Loco(model=model, mode='mono', device='cuda').forward(kps, kk)
    env = dict(os.environ, MONOLOCO_TPU_PRECISION='int8')
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, '-m', 'monoloco_tpu_torch.serve', '--model', model,
                             '--port', '0'], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, serving = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith('serving '):
                serving.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not serving.wait(180):
            fail(f"the server printed no 'serving' line: {lines[-20:]}")
        port = int(re.search(r'http://[^:]+:(\d+)', lines[-1]).group(1))
        print(f"{lines[-1]} (up in {time.perf_counter() - t0:.1f} s)", flush=True)
        health = _get_json(port, '/healthz')
        print(f"/healthz: {json.dumps(health)}")
        check(health['precision'] == 'int8' and health['int8_kernel'] is True,
              "healthz: not serving int8 with the kernel packed")

        def payload(c, i):
            req = {'keypoints': kps, 'kk': kk}
            if (c + i) % 2:
                req['boxes'] = boxes
            return req

        t1 = time.perf_counter()
        responses = _fire_clients(port, payload)
        wall = time.perf_counter() - t1
        metrics = _get_json(port, '/metrics')
        print(f"/metrics: {json.dumps(metrics)}")
        print(f"{len(responses)} requests in {wall:.3f} s: {len(responses) / wall:.1f} "
              f"requests/s, {len(responses) * SERVE_DETS / wall:.1f} inferences/s", flush=True)
        check(metrics['int8_dispatches'] > 0 and metrics['shed'] == 0
              and metrics['mean_batch'] > 1, "metrics: no int8 dispatch, shed, or no coalescing")
        with_pp = [r for c, i, r in responses if (c + i) % 2]
        check(all(len(r['post_process']['dds_pred']) == SERVE_DETS for r in with_pp)
              and all('post_process' not in r for c, i, r in responses if not (c + i) % 2),
              "post_process present where boxes were not sent, or missing where they were")
        rel = _rel_dev(responses, ref)
        print(f"int8 distances of {len(responses)} responses against float32 Loco: mean "
              f"relative deviation {rel:.3e} (budget {DYN8_BUDGET})")
        check(rel < DYN8_BUDGET, "served int8 distances outside the dyn8 budget")
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(10)
        except subprocess.TimeoutExpired:
            fail("the server did not exit within 10 s of SIGTERM")
        check(code == 0, f"the server exited {code} after SIGTERM: {lines[-20:]}")
        print(f"SIGTERM: exited 0 in {time.perf_counter() - t0:.1f} s of life")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)


def _serve_in_process(net, payload):
    """An in-process Server on port 0 over `net`, warmed up, every launch
    count and the net's dispatch counters set to 0, then the client
    pattern, traced by torch.profiler (device activity only) for the
    device's busy share of serving. Returns (responses, metrics, launches,
    the dispatches' batch sizes)."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.serve import Server
    srv = Server(net, port=0)
    srv.warmup()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        torch.cuda.synchronize()
        _zero_launches()
        net.n_dispatches = net.n_dispatches_int8 = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            responses = _fire_clients(srv.port, payload)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        metrics = _get_json(srv.port, '/metrics')
    finally:
        srv.shutdown()
    sizes = list(srv.batcher.batch_sizes)
    ran = {k: n for k, n in launches.items() if n}
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    share = f"{busy / wall:.4%} ({busy * 1e3:.3f} ms of device activity)" if busy else \
        "not measured (the profiler saw no device activity)"
    print(f"  {len(responses)} requests in {wall:.3f} s ({len(responses) / wall:.1f} requests/s, "
          f"under the profiler), dispatches {metrics['dispatches']}, int8 "
          f"{metrics['int8_dispatches']}, mean batch {metrics['mean_batch']:.2f}, max "
          f"{metrics['max_batch']}, device_ms {metrics['device_ms']}, latency_ms "
          f"{metrics['latency_ms']}, launches {ran}; device busy share {share}", flush=True)
    check(metrics['shed'] == 0, "requests were shed")
    return responses, metrics, ran, sizes


def _max_rel(response, own):
    """{key: max |diff| / (1 + |ref|)} of a response's outputs against
    one image's forward outputs."""
    err = {}
    for key, v in own.items():
        a = np.asarray(response['outputs'][key], np.float64)
        b = np.asarray([np.asarray(x) for x in v] if key == 'yaw' else v, np.float64)
        err[key] = float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0
    return err


def check_default_responses(net, responses, sizes, kps, kk):
    """Every response of the default server equals, within 1e-5 (1 +
    |ref|), `Loco.forward_batch` of a batch like the one it was dispatched
    in: the fixture image B times, for a B the batcher dispatched (the f32
    products' sum order may depend on the batch's shape)."""
    refs = [own for b in sorted(set(sizes)) for own in net.forward_batch([kps] * b, [kk] * b)]
    alone = net.forward_batch([kps], [kk])[0]
    worst = max(min(max(_max_rel(r, own).values()) for own in refs) for _, _, r in responses)
    single = {}
    for _, _, r in responses:
        for key, e in _max_rel(r, alone).items():
            single[key] = max(single.get(key, 0.0), e)
    print(f"  every response against Loco.forward_batch of its dispatch's batch size "
          f"({len(set(sizes))} sizes): max |diff| / (1 + |ref|) {worst:.3e} (tolerance 1e-5); "
          f"against one image alone, by key: "
          + ", ".join(f"{k} {v:.1e}" for k, v in single.items()))
    check(worst <= 1e-5, "default responses differ from Loco.forward_batch")


def phase_serve_kernels(tmp, s_params, s_bn):
    """In-process servers counting launches: mono int8 (dyn8), stereo int8
    (dyn8 at 68 -> 10), mono bf16 (K1-bf16 on every dispatch), mono default
    (no launch, equal to Loco.forward_batch). Returns the launch counts."""
    from monoloco_tpu_torch.geometry import BF
    from monoloco_tpu_torch.models import fold_eval_params, save_checkpoint
    from monoloco_tpu_torch.network import Loco, preprocess_monstereo
    from monoloco_tpu_torch.ops import fused_loco_forward_dyn8_auto, pack_folded_weights_w8
    banner(f"== phase 16: in-process servers, {SERVE_CLIENTS} clients x {SERVE_REQUESTS} "
          f"requests", flush=True)
    model = _main_model(tmp)
    kps, _, kk = _fixture_request()
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    ref = Loco(model=model, mode='mono', device='cuda').forward(kps, kk)
    counts = {}

    def mono(c, i):
        return {'keypoints': kps, 'kk': kk}

    for precision, kernel in (('int8', 'dyn8_mlp'), ('bf16', 'fused_mlp_bf16'),
                              ('default', None)):
        os.environ['MONOLOCO_TPU_PRECISION'] = precision
        net = Loco(model=model, mode='mono', device='cuda')
        print(f"mono {precision}:", flush=True)
        responses, metrics, ran, sizes = _serve_in_process(net, mono)
        if precision == 'default':
            check(ran == {}, f"default serving launched {ran}")
            check_default_responses(net, responses, sizes, kps, kk)
            continue
        check(ran.get(kernel, 0) > 0, f"mono {precision}: {kernel} never launched")
        if precision == 'bf16':
            check(ran.get(kernel) == metrics['dispatches'] and 'dyn8_mlp' not in ran,
                  f"bf16: {ran} for {metrics['dispatches']} dispatches")
        else:
            check(metrics['int8_dispatches'] > 0, "int8: no dispatch routed")
        counts[kernel] = counts.get(kernel, 0) + ran.get(kernel, 0)
        rel = _rel_dev(responses, ref)
        print(f"  distances against float32 Loco: mean relative deviation {rel:.3e} (budget "
              f"{DYN8_BUDGET if precision == 'int8' else BF16_BUDGET})")
        check(rel < (DYN8_BUDGET if precision == 'int8' else BF16_BUDGET),
              f"served {precision} distances outside the budget")

    # Stereo: 16 left and 16 right poses a request (256 pairing rows).
    s_model = os.path.join(tmp, f'monstereo_serve_h{HIDDEN}.pkl')
    save_checkpoint(s_model, s_params, s_bn, meta={'seed': SEED + 2})
    rng = np.random.default_rng(SEED + 17)
    right = np.asarray(kps, np.float32).copy()
    right[:, 0, :] -= (BF / rng.uniform(5, 40, size=len(right)))[:, None]
    right = right.tolist()
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    s_ref = Loco(model=s_model, mode='stereo', device='cuda').forward(kps, kk, right)
    folded = fold_eval_params(_to_cuda(s_params), _to_cuda(s_bn))
    with torch.inference_mode():
        rows, _ = preprocess_monstereo(*(torch.tensor(np.asarray(a, np.float32), device='cuda')[None]
                                         for a in (kps, right, kk)))
        raw = fused_loco_forward_dyn8_auto(pack_folded_weights_w8(folded),
                                           rows.reshape(-1, STEREO_IN).contiguous())
    choice8 = torch.argmax(raw.reshape(len(kps), len(right), STEREO_OUT)[..., -1], dim=1)
    same = (choice8.cpu().numpy() == np.asarray(s_ref['aux_idx']).reshape(-1))
    os.environ['MONOLOCO_TPU_PRECISION'] = 'int8'
    net = Loco(model=s_model, mode='stereo', device='cuda')
    print("stereo int8:", flush=True)
    responses, metrics, ran, _ = _serve_in_process(
        net, lambda c, i: {'keypoints': kps, 'keypoints_r': right, 'kk': kk})
    check(ran.get('dyn8_mlp', 0) > 0 and metrics['int8_dispatches'] > 0,
          "stereo int8: dyn8 never launched")
    counts['dyn8_mlp'] += ran.get('dyn8_mlp', 0)
    check(same.any(), "int8 and float32 never choose the same right pose")
    d = np.stack([np.asarray(r['outputs']['d'], np.float64).reshape(-1) for _, _, r in responses])
    d32 = np.asarray(s_ref['d'], np.float64).reshape(-1)
    rel = float(np.abs(d[:, same] - d32[same]).mean() / np.abs(d32[same]).mean())
    print(f"  right pose chosen differently (dyn8 vs float32) for {int((~same).sum())} of "
          f"{same.size} left poses; distances where the choice agrees: mean relative deviation "
          f"{rel:.3e} (budget {DYN8_BUDGET})")
    check(rel < DYN8_BUDGET, "served stereo int8 distances outside the dyn8 budget")
    return counts


def phase_serve_tools():
    """bench_serve (int8, default, --direct --sweep), bench_latency and
    bench_int8_crossover as a user runs them; returns the launch counts."""
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.tools import bench_int8_crossover, bench_latency, bench_serve
    banner("== phase 17: the serving tools (bench_serve, bench_latency, bench_int8_crossover)",
          flush=True)
    _zero_launches()
    closed = ['--clients', '32', '--requests', '20', '--dets', '16']
    for precision, extra in (('int8', ['--expect-int8']), ('default', []), ('bf16', [])):
        os.environ['MONOLOCO_TPU_PRECISION'] = precision
        print(f"bench_serve {' '.join(closed + extra)} under {precision}:", flush=True)
        rec, = bench_serve.main(closed + extra)
        check(np.isfinite(rec['value']) and rec['value'] > 0, "bench_serve: bad requests/s")
    os.environ['MONOLOCO_TPU_PRECISION'] = 'int8'
    direct = ['--direct', '--sweep', '500,2000,8000', '--duration', '2', '--dets', '16',
              '--expect-int8']
    print(f"bench_serve {' '.join(direct)} under int8:", flush=True)
    records = bench_serve.main(direct)
    check(len(records) == 4 and all(r['ok'] > 0 for r in records[:3]), "direct sweep records")
    os.environ['MONOLOCO_TPU_PRECISION'] = 'default'
    records = bench_latency.main(['--batches', '1,16,256,4096'])
    for rec in records[1:]:
        check(np.isfinite(rec['checksum']), f"bench_latency {rec['precision']}: bad checksum")
        kernel = {'default': None, 'bf16': 'fused_mlp_bf16', 'int8': 'dyn8_mlp'}[rec['precision']]
        check(rec['launches'].get(kernel, 0) > 0 if kernel else rec['launches'] == {},
              f"bench_latency {rec['precision']}: launches {rec['launches']}")
    records = bench_int8_crossover.main(['--rows', CROSSOVER_ROWS])
    for rec in records[:-1]:
        check(all(np.isfinite(v) for v in rec['checksum'].values()),
              f"crossover at {rec['rows']} rows: bad checksum")
        check(rec['launches']['dyn8'].get('dyn8_mlp', 0) > 0
              and rec['launches']['bf16'].get('fused_mlp_bf16', 0) > 0
              and rec['launches']['f32'] == {}, f"crossover launches {rec['launches']}")
    return dict(launches)


def _generate_eval(model, precision, mode='mono', profiled=False):
    """`eval --generate --dir_ann annotations --model <model>` through the
    entry point, in the working directory, at `precision`, every launch
    count set to 0 just before; the txt tree is copied aside. With
    `profiled` the run is under torch.profiler, for the device's busy share.
    Returns (the record printed, the tree's directory, the GenerateKitti)."""
    from torch.profiler import ProfilerActivity, profile
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.tools.eval_parity import extract_metrics
    os.environ['MONOLOCO_TPU_PRECISION'] = precision
    _zero_launches()
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        gen, ev = run.main(['eval', '--generate', '--dir_ann', 'annotations', '--model', model,
                            '--mode', mode])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ran = {k: n for k, n in launches.items() if n}
    tree = f'txt_{mode}_{precision}'
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join('data', 'kitti', gen.net), tree)
    n_images = len(os.listdir(tree))
    net = gen.model
    rec = {'phase': 18, 'mode': mode, 'precision': precision, 'images': n_images,
           'wall_s': wall, 'images_per_s': n_images / wall, 'dispatches': net.n_dispatches,
           'dispatches_int8': net.n_dispatches_int8, 'launches': ran,
           **extract_metrics(ev, gen.net)}
    if profiled:
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        rec['device_busy_s'] = busy
        rec['device_busy_share'] = busy / wall if busy else 'not measured'
    print(json.dumps(rec), flush=True)
    chunks = -(-n_images // GEN_CHUNK)
    check(net.n_dispatches == chunks, f"{mode} {precision}: {net.n_dispatches} dispatches for "
                                      f"{chunks} chunks")
    kernel = {'int8': 'dyn8_mlp', 'bf16': 'fused_mlp_bf16'}.get(precision)
    check(ran == ({kernel: chunks} if kernel else {}),
          f"{mode} {precision}: launches {ran} for {chunks} chunks")
    check(net.n_dispatches_int8 == (chunks if precision == 'int8' else 0),
          f"{mode} {precision}: {net.n_dispatches_int8} int8 dispatches of {chunks}")
    return rec, tree, gen


def _tree_distances(tree):
    """Per txt file (name order) the distance of each row, the norm of xyz."""
    out = []
    for name in sorted(os.listdir(tree)):
        with open(os.path.join(tree, name)) as f:
            out.append(np.array([np.linalg.norm(np.array(line.split()[11:14], float))
                                 for line in f]))
    return out


def _stereo_same_choice(gen_a, gen_b, tree):
    """Rows (in tree order) whose right pose both generations chose alike."""
    return np.concatenate([gen_a.aux_idx[name[:-4]] == gen_b.aux_idx[name[:-4]]
                           for name in sorted(os.listdir(tree))])


def phase_generate(tmp, model, s_params, s_bn):
    """KITTI txt generation and ALE/ALP evaluation at full volume through the
    entry point, mono at float32, int8 (under torch.profiler) and bf16,
    stereo at float32 and int8; returns (the dataset's root, the launch
    counts)."""
    from monoloco_tpu_torch.models import save_checkpoint
    from monoloco_tpu_torch.tools import eval_parity, make_synthetic_kitti
    banner(f"== phase 18: eval --generate + EvalKitti through the entry point, {GEN_VAL} "
          f"val scenes (hard mode), {GEN_CHUNK}-image chunks", flush=True)
    root = os.path.join(tmp, 'kitti_hard')
    t0 = time.perf_counter()
    make_synthetic_kitti.make_dataset(root, n_train=GEN_TRAIN, n_val=GEN_VAL, seed=1,
                                      hard=True, images=False)
    print(f"dataset: {GEN_VAL} val scenes, hard mode, seed 1, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    s_model = os.path.join(tmp, 'monstereo_h1024.pkl')
    save_checkpoint(s_model, s_params, s_bn, meta={'seed': SEED + 2})
    counts = {}
    old = os.getcwd()
    os.chdir(root)
    try:
        mono = {p: _generate_eval(model, p, profiled=p == 'int8') for p in GEN_PRECISIONS}
        for p in GEN_PRECISIONS[1:]:
            diff = eval_parity.txt_tree_diff(mono['float32'][1], mono[p][1])
            print(f"mono {p} vs float32: {json.dumps(diff)} (budget {DYN8_BUDGET} mean)")
            check(0 < diff['mean_rel_dd'] < DYN8_BUDGET,
                  f"mono {p}: distance deviation outside the budget")
            kernel = 'dyn8_mlp' if p == 'int8' else 'fused_mlp_bf16'
            counts[kernel] = counts.get(kernel, 0) + mono[p][0]['launches'].get(kernel, 0)

        stereo = {p: _generate_eval(s_model, p, mode='stereo') for p in ('float32', 'int8')}
        (_, t32, g32), (_, t8, g8) = stereo['float32'], stereo['int8']
        eval_parity.txt_tree_diff(t32, t8)          # same files, rows, detections
        same = _stereo_same_choice(g32, g8, t32)
        d32, d8 = np.concatenate(_tree_distances(t32)), np.concatenate(_tree_distances(t8))
        rel = float((np.abs(d8 - d32)[same] / d32[same]).mean())
        print(f"stereo int8 vs float32 over {len(os.listdir(t32))} pairs: right pose chosen "
              f"differently for {int((~same).sum())} of {same.size} left poses; distances "
              f"where the choice agrees: mean relative deviation {rel:.3e} "
              f"(budget {DYN8_BUDGET})", flush=True)
        check(same.mean() > 0.9 and rel < DYN8_BUDGET,
              "stereo int8 distances outside the dyn8 budget")
        counts['dyn8_mlp'] += stereo['int8'][0]['launches'].get('dyn8_mlp', 0)
    finally:
        os.chdir(old)
    return root, counts


def phase_generate_chunk(root, model, kernels, folded):
    """dyn8 and K1-bf16 against their plain versions on the padded rows
    (after K^-1) of the 64-image chunk of phase 18 with the most detections
    an image, as `forward_batch_async` pads them, with times at that shape."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.eval import GenerateKitti
    from monoloco_tpu_torch.models import folded_forward
    from monoloco_tpu_torch.network import preprocess_monoloco
    from monoloco_tpu_torch.network.engine import _bucket
    t0 = time.perf_counter()
    old = os.getcwd()
    os.chdir(root)
    try:
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
        gen = GenerateKitti(run.cli(['eval', '--generate', '--dir_ann', 'annotations',
                                     '--model', model]))
        loaded = []
        for basename in sorted(gen.set_basename):
            _, keypoints, kk, *_ = gen._load_image(basename, False)
            if keypoints:
                loaded.append((np.asarray(keypoints, np.float32), np.asarray(kk, np.float32)))
    finally:
        os.chdir(old)
    chunks = [loaded[i:i + GEN_CHUNK] for i in range(0, len(loaded), GEN_CHUNK)]
    chunk = max(chunks, key=lambda c: (len(c), max(len(k) for k, _ in c)))
    m_bucket = _bucket(max(len(k) for k, _ in chunk))
    kps = np.zeros((len(chunk), m_bucket, 3, 17), np.float32)
    kks = np.zeros((len(chunk), 3, 3), np.float32)
    for i, (k, kk) in enumerate(chunk):
        kps[i, :len(k)] = k
        kks[i] = kk
    x = preprocess_monoloco(torch.from_numpy(kps).cuda(), torch.from_numpy(kks).cuda())
    x = x.reshape(-1, IN_DIM).contiguous()
    banner(f"== phase 19: dyn8 and K1-bf16 vs plain on a generate chunk: {len(chunk)} images x "
          f"{m_bucket} detections = {x.shape[0]} rows", flush=True)
    f32_ref = folded_forward(folded, x)
    worst, ms = {}, {}
    for name, rule in (('dyn8_mlp', 'int8'), ('fused_mlp_bf16', 'bf16')):
        entry, plain, packed = kernels[name]
        worst[name] = _compare(f"{name} chunk", rule, entry(packed, x), plain(packed, x), f32_ref)
        med, lo, hi = _median_ms(lambda: entry(packed, x))
        ms[name] = med
        print(f"  {name} at {x.shape[0]} rows: {med:.4f} ms (min {lo:.4f}, max {hi:.4f})")
    med, lo, hi = _median_ms(lambda: folded_forward(folded, x))
    ms['f32_folded'] = med
    print(f"  f32 folded (torch.matmul) at {x.shape[0]} rows: {med:.4f} ms (min {lo:.4f}, "
          f"max {hi:.4f})", flush=True)
    print(json.dumps({'phase': 19, 'rows': x.shape[0], 'max_abs_err': worst, 'ms': ms,
                      'wall_s': time.perf_counter() - t0}), flush=True)
    return worst


def phase_int8_ab(tmp):
    """`tools.eval_parity` on the JAX-trained byte-compat checkpoint (hidden
    128) over an easy-mode val set of another seed than its training set's;
    returns the launch counts of its legs."""
    from monoloco_tpu_torch.tools import eval_parity, make_synthetic_kitti
    banner(f"== phase 20: int8 and bf16 end-metric A/B (tools.eval_parity), trained checkpoint, "
          f"{GEN_VAL} val scenes (easy mode, seed {AB_SEED})", flush=True)
    root = os.path.join(tmp, 'kitti_ab')
    make_synthetic_kitti.make_dataset(root, n_train=GEN_TRAIN, n_val=GEN_VAL, seed=AB_SEED,
                                      images=False)
    rec = eval_parity.main([root, '--model', os.path.join(GOLD, 'model_tpu.pkl')])
    legs, ref = rec['legs'], rec['legs']['float32']
    for p, kernel in (('int8', 'dyn8_mlp'), ('bf16', 'fused_mlp_bf16')):
        if p not in legs:
            continue
        leg = legs[p]
        check(leg['launches'] == {kernel: leg['dispatches']},
              f"A/B {p}: launches {leg['launches']} for {leg['dispatches']} dispatches")
        check(leg['dispatches_int8'] == (leg['dispatches'] if p == 'int8' else 0),
              f"A/B {p}: {leg['dispatches_int8']} int8 dispatches")
        alp = {g: leg['alp'][g] - ref['alp'][g] for g in ref['alp']}
        print(f"A/B {p}: ALE (all) {rec['ale_all_delta_pct'][p]:+.4f}% of float32's "
              f"{ref['ale']['all']:.4f} m; ALP points {alp}; rows "
              f"{json.dumps(rec['txt_row_diff'][p])}", flush=True)
        check(abs(rec['ale_all_delta_pct'][p]) <= AB_ALE_PCT
              and all(abs(v) <= AB_ALP_POINTS for v in alp.values()),
              f"A/B {p}: end metric outside 2% ALE / 1 point ALP of float32")
    check(legs['float32']['launches'] == {}, "A/B float32 leg launched a kernel")
    return {'dyn8_mlp': legs['int8']['launches'].get('dyn8_mlp', 0),
            'fused_mlp_bf16': legs['bf16']['launches'].get('fused_mlp_bf16', 0)}


def phase_prep(tmp):
    """`run prep` on a hard-mode synthetic KITTI tree with images, mono and
    stereo; returns (the tree's root, {mode: the joints file})."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.geometry.host import np_preprocess_monoloco
    from monoloco_tpu_torch.tools import make_synthetic_kitti
    banner(f"== phase 21: prep through the entry point, {PREP_TRAIN} train + {PREP_VAL} val "
          f"scenes (hard mode, images written)", flush=True)
    root = os.path.join(tmp, 'kitti_prep')
    t0 = time.perf_counter()
    make_synthetic_kitti.make_dataset(root, n_train=PREP_TRAIN, n_val=PREP_VAL, seed=PREP_SEED,
                                      hard=True, images=True)
    print(f"dataset: seed {PREP_SEED}, written in {time.perf_counter() - t0:.2f} s", flush=True)
    joints = {}
    old = os.getcwd()
    os.chdir(root)
    try:
        for mode in ('mono', 'stereo'):
            t0 = time.perf_counter()
            prep = run.main(['prep', '--dir_ann', 'annotations', '--mode', mode])
            wall = time.perf_counter() - t0
            jo = prep.dic_jo
            rows = {ph: len(jo[ph]['X']) for ph in ('train', 'val')}
            print(json.dumps({'phase': 21, 'mode': mode, 'wall_s': wall, 'rows': rows,
                              'joints_bytes': os.path.getsize(prep.path_joints),
                              'names_bytes': os.path.getsize(prep.path_names)}), flush=True)
            check(rows['train'] > 1000 and rows['val'] > 100, f"prep {mode}: rows {rows}")
            # Each row's inputs are its keypoints through K^-1 (the left half
            # for stereo), and its labels a person in front of the camera.
            width = 34 if mode == 'mono' else 68
            for ph in ('train', 'val'):
                x = np.asarray(jo[ph]['X'], np.float32)
                y = np.asarray(jo[ph]['Y'], np.float32)
                kps = np.asarray(jo[ph]['kps'], np.float32)[:, 0, :, :17]
                ref = np.concatenate([np_preprocess_monoloco(k, kk)
                                      for k, kk in zip(kps, jo[ph]['K'])])
                check(x.shape[1] == width and np.array_equal(x[:, :34], ref),
                      f"prep {mode} {ph}: inputs are not the keypoints through K^-1")
                check(bool((y[:, 2] > 0).all() and (y[:, 3] >= y[:, 2] - 1e-4).all()),
                      f"prep {mode} {ph}: labels with z <= 0 or d < z")
            joints[mode] = os.path.abspath(prep.path_joints)
    finally:
        os.chdir(old)
    return root, joints


def _train_args(joints, mode='mono', extra=()):
    return ['train', '--joints', joints, '--mode', mode, '--bs', str(TRAIN_BS), '--dropout',
            str(TRAIN_DROPOUT), '--hidden_size', str(HIDDEN), '--n_stage', str(STAGES), *extra]


def _copy_training_state(dst, src):
    """Put `src`'s weights, BN statistics, Adam moments and step count into
    the trainer `dst` (on its own device)."""
    with torch.no_grad():
        for a, b in zip(dst._model_leaves, src._model_leaves):
            a.copy_(b)
    dst.bn_state = _to_device(src.bn_state, dst.device)
    for a, b in zip(dst.optimizer.param_groups[0]['params'],
                    src.optimizer.param_groups[0]['params']):
        dst.optimizer.state[a] = {k: v.detach().to(dst.device if k != 'step' else v.device)
                                  .clone() for k, v in src.optimizer.state[b].items()}
    dst.n_steps = src.n_steps


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.detach().to(device).clone()


def phase_train_parity(joints):
    """The training step on the card against the CPU: from the same weights,
    on the same rows with the keep-masks the card drew, PARITY_STEPS steps
    each. First free-running (each device from its own previous step; the
    deviation is printed), then each CPU step from the card's state before
    it, where the losses and gradient norms must agree within
    TRAIN_PARITY_TOL relative. Returns the worst relative deviation of the
    checked steps."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.models import n_dropout_sites, train_keep_masks
    from monoloco_tpu_torch.train import Trainer
    banner(f"== phase 22: training, card vs CPU: {PARITY_STEPS} steps at hidden {HIDDEN}, "
          f"{STAGES} stages, bs {TRAIN_BS}, dropout {TRAIN_DROPOUT}, float32", flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    args = run.cli(_train_args(joints, extra=('--no_save',)))
    card = Trainer(args)
    cpu = Trainer(args, device='cpu')
    cpu.set_weights(card.params, card.bn_state)
    check(card.device.type == 'cuda' and card.n_train >= PARITY_STEPS * TRAIN_BS // 2,
          f"training parity: device {card.device}, {card.n_train} rows")
    order = torch.cat([card._permutation(0), card._permutation(1)])
    worst = {}
    for synced in (False, True):
        for s in range(PARITY_STEPS):
            idx = order[s * TRAIN_BS:(s + 1) * TRAIN_BS]
            masks = train_keep_masks(TRAIN_BS, HIDDEN, n_dropout_sites(STAGES), TRAIN_DROPOUT,
                                     card.gen, card.device)
            if synced:
                _copy_training_state(cpu, card)
            loss_c, gn_c, _ = card.step(card.x_tr[idx], card.y_tr[idx], masks=masks)
            idx_h = idx.cpu()
            t0 = time.perf_counter()
            loss_h, gn_h, _ = cpu.step(cpu.x_tr[idx_h], cpu.y_tr[idx_h],
                                       masks=[m.cpu() for m in masks])
            cpu_s = time.perf_counter() - t0
            rel_l = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
            rel_g = abs(float(gn_c) - float(gn_h)) / float(gn_h)
            kind = 'from the card state' if synced else 'free-running'
            worst[kind] = max(worst.get(kind, 0.0), rel_l, rel_g)
            print(f"  {kind} step {card.n_steps - 1}: loss card {float(loss_c):.6f} cpu "
                  f"{float(loss_h):.6f} (rel {rel_l:.2e}), grad norm card {float(gn_c):.6f} "
                  f"cpu {float(gn_h):.6f} (rel {rel_g:.2e}); cpu step {cpu_s:.2f} s", flush=True)
            if synced:
                check(rel_l <= TRAIN_PARITY_TOL and rel_g <= TRAIN_PARITY_TOL,
                      f"training step {s}: the card's loss or gradient norm is off the CPU's")
    print(json.dumps({'phase': 22, 'check': 'card vs cpu', 'steps': PARITY_STEPS,
                      'max_rel': worst, 'tol': TRAIN_PARITY_TOL}), flush=True)
    return worst['from the card state']


def _busy_share_of_an_epoch(joints, mode):
    """The device's busy share of one epoch (the second of a fresh trainer,
    at the environment's precision): (CUDA kernel time, the epoch's wall,
    the CUDA kernels launched, the kernel time of cuBLAS's products (names
    with 'gemm' or 'nvjet'), the five kernels of most time as [name, ms,
    launches])."""
    from torch.profiler import ProfilerActivity, profile
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.train import Trainer
    trainer = Trainer(run.cli(_train_args(joints, mode, ('--no_save',))))
    trainer.run_epoch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_epoch(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    gemm = sum(e.time_range.elapsed_us() for e in kernels
               if 'gemm' in e.name.lower() or 'nvjet' in e.name.lower()) / 1e6
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return busy, wall, len(kernels), gemm, [[k[:80], us / 1e3, n] for k, (us, n) in top]


def _timed_train(tmp, joints, mode, precision, epochs):
    """`run train` at `precision` for `epochs`, launch counts zeroed before;
    prints and returns its record, with the checkpoint's path."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.ops import launches
    os.environ['MONOLOCO_TPU_PRECISION'] = precision
    out = os.path.join(tmp, f'{mode}_{precision}.pkl')
    _zero_launches()
    t0 = time.perf_counter()
    trainer = run.main(_train_args(joints, mode, ('--epochs', str(epochs), '--out', out)))
    wall = time.perf_counter() - t0
    ran = {k: n for k, n in launches.items() if n}
    check(not ran, f"training launched serving kernels: {ran}")
    check(trainer.device.type == 'cuda' and os.path.exists(out),
          f"train {mode} {precision}: device {trainer.device}, checkpoint {out}")
    steps = -(-trainer.n_train // TRAIN_BS)
    epoch_s = statistics.median(trainer.epoch_walls[1:])
    val_d = trainer.epoch_losses['val']['d']
    busy, busy_wall, n_kernels, gemm, top = _busy_share_of_an_epoch(joints, mode)
    rec = {'phase': 22, 'mode': mode, 'precision': precision, 'hidden': HIDDEN,
           'stages': STAGES, 'bs': TRAIN_BS, 'rows': trainer.n_train, 'epochs': epochs,
           'steps_per_epoch': steps, 'epoch_wall_s': epoch_s,
           'first_epoch_wall_s': trainer.epoch_walls[0],
           'steps_per_s': steps / epoch_s, 'samples_per_s': trainer.n_train / epoch_s,
           'run_wall_s': wall, 'val_d_first': val_d[0], 'val_d_best': min(val_d),
           'best_epoch': trainer.best_epoch, 'device_busy_s': busy,
           'profiled_epoch_wall_s': busy_wall, 'device_busy_share': busy / busy_wall,
           'cuda_kernels_per_step': n_kernels / steps, 'gemm_device_s': gemm,
           'top_kernels': top}
    print(json.dumps(rec), flush=True)
    check(all(np.isfinite(v) for v in val_d), f"train {mode} {precision}: val d not finite")
    check(trainer.best_epoch > 0 and val_d[trainer.best_epoch] < val_d[0],
          f"train {mode} {precision}: the val d loss did not fall ({val_d})")
    return rec, out


def phase_train(tmp, joints):
    """The card-vs-CPU step check, then timed `run train` at full width per
    precision (mono), and MonStereo at float32; returns the float32 mono
    checkpoint."""
    phase_train_parity(joints['mono'])
    banner(f"== phase 22: run train on the card, MonoLoco++ 34 -> 9, hidden {HIDDEN}, "
          f"{STAGES} stages, bs {TRAIN_BS}, dropout {TRAIN_DROPOUT}, {TRAIN_EPOCHS} epochs a "
          f"precision; MonStereo 68 -> 10 at float32, {STEREO_TRAIN_EPOCHS} epochs", flush=True)
    ckpt = {}
    for precision in TRAIN_PRECISIONS:
        _, ckpt[precision] = _timed_train(tmp, joints['mono'], 'mono', precision, TRAIN_EPOCHS)
    _timed_train(tmp, joints['stereo'], 'stereo', 'float32', STEREO_TRAIN_EPOCHS)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    return ckpt['float32']


def phase_trained_eval(root, model):
    """`eval --generate` + EvalKitti with the card-trained checkpoint on the
    prep tree's val scenes, at float32."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.eval import EvalKitti
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.tools.eval_parity import extract_metrics
    banner(f"== phase 23: the card-trained checkpoint through eval --generate + EvalKitti, "
          f"{PREP_VAL} val scenes", flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    old = os.getcwd()
    os.chdir(root)
    try:
        _zero_launches()
        t0 = time.perf_counter()
        argv = ['eval', '--generate', '--dir_ann', 'annotations', '--model', model]
        gen, ev = run.main(argv)
        wall = time.perf_counter() - t0
        n_images = len(os.listdir(os.path.join('data', 'kitti', gen.net)))
        # The same txt tree scored with every detection kept (the confidence
        # floor off, as tools.eval_parity scores): a briefly trained net's
        # spread can put its confidences under EvalKitti's 0.2.
        ev_all = EvalKitti(run.cli(argv))
        ev_all.dic_thresh_conf[gen.net] = -100
        ev_all.run()
    finally:
        os.chdir(old)
    metrics = extract_metrics(ev, gen.net)
    metrics_all = extract_metrics(ev_all, gen.net)
    print(json.dumps({'phase': 23, 'model': os.path.basename(model), 'images': n_images,
                      'wall_s': wall, 'dispatches': gen.model.n_dispatches,
                      'device': str(gen.model.device), **metrics,
                      'every_detection': metrics_all}), flush=True)
    # A val scene whose pifpaf file holds no detection gets no txt file.
    check(0.95 * PREP_VAL <= n_images <= PREP_VAL and gen.model.device.type == 'cuda',
          f"trained eval: {n_images} txt files on {gen.model.device}")
    check(not any(launches.values()), "float32 generation launched a kernel")
    check(metrics_all['matched'] > 0 and np.isfinite(metrics_all['ale']['all']),
          f"trained eval: {metrics_all}")


def phase_resume(tmp, joints):
    """`run train` straight for 2E epochs against E epochs, then `--resume`
    for E more, at full width; a zero-epoch resume. Returns the straight
    run's checkpoint."""
    import pickle
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.models import load_checkpoint
    banner(f"== phase 24: train --resume on the card, hidden {HIDDEN}, bs {TRAIN_BS}: "
           f"{2 * RESUME_EPOCHS} epochs straight against {RESUME_EPOCHS} + resume "
           f"{RESUME_EPOCHS}", flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    paths = {k: os.path.join(tmp, f'resume_{k}.pkl') for k in ('straight', 'half', 'resumed',
                                                               'zero')}
    t0 = time.perf_counter()
    straight = run.main(_train_args(joints, extra=('--epochs', str(2 * RESUME_EPOCHS), '--out',
                                                   paths['straight'])))
    wall_straight = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.main(_train_args(joints, extra=('--epochs', str(RESUME_EPOCHS), '--out',
                                        paths['half'])))
    resumed = run.main(_train_args(joints, extra=('--epochs', str(2 * RESUME_EPOCHS), '--out',
                                                  paths['resumed'], '--resume', paths['half'])))
    wall_resumed = time.perf_counter() - t0
    check(straight.device.type == 'cuda' and resumed.device.type == 'cuda',
          "resume: training did not run on the card")
    check(resumed.start_epoch == RESUME_EPOCHS, f"resume: start epoch {resumed.start_epoch}")
    a = np.asarray(straight.epoch_losses['val']['d'][RESUME_EPOCHS:])
    b = np.asarray(resumed.epoch_losses['val']['d'])
    final = {ph: [np.asarray([straight.epoch_losses[ph][n][-1] for n in names]),
                  np.asarray([resumed.epoch_losses[ph][n][-1] for n in names])]
             for ph in ('train', 'val') for names in [['all'] + list(straight.tasks)]}
    diff = max(float(np.abs(x - y).max()) for x, y in final.values())
    weights = max(float((x - y).abs().max()) for x, y in
                  zip(_leaves(straight.final_params), _leaves(resumed.final_params)))
    print(json.dumps({'phase': 24, 'epochs': 2 * RESUME_EPOCHS, 'val_d_straight': a.tolist(),
                      'val_d_resumed': b.tolist(), 'max_abs_diff_final_losses': diff,
                      'max_abs_diff_final_weights': weights,
                      'best_epoch': [straight.best_epoch, resumed.best_epoch],
                      'wall_s': {'straight': wall_straight, 'half_and_resume': wall_resumed}}),
          flush=True)
    for x, y in final.values():
        check(np.allclose(y, x, rtol=RESUME_TOL, atol=RESUME_TOL),
              f"resume: final losses {y} against the straight run's {x}")
    check(resumed.best_epoch == straight.best_epoch, "resume: another best epoch")
    # A resume with no new epochs keeps the best weights and the epoch.
    zero = run.main(_train_args(joints, extra=('--epochs', str(2 * RESUME_EPOCHS), '--out',
                                               paths['zero'], '--resume', paths['resumed'])))
    with open(paths['zero'], 'rb') as f:
        meta = pickle.load(f)['meta']
    best_p, best_bn, _ = load_checkpoint(paths['resumed'], device=zero.device)
    same = all(torch.equal(x, y) for x, y in zip(_leaves(zero.params), _leaves(best_p))) and all(
        torch.equal(x, y) for x, y in zip(_leaves(zero.bn_state), _leaves(best_bn)))
    print(f"zero-epoch resume: meta epoch {meta['epoch']}, best_val_acc {meta['best_val_acc']}, "
          f"best weights bit for bit: {same}", flush=True)
    check(same and meta['epoch'] == 2 * RESUME_EPOCHS
          and meta['best_val_acc'] == resumed.best_acc,
          f"zero-epoch resume: {meta} (best weights equal: {same})")
    return paths['straight']


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _stacked_to_trainer(st, k, t):
    """Put trial k of the StackedTrials `st` (weights, BN statistics, Adam
    moments and step, update count) into the Trainer `t`."""
    from monoloco_tpu_torch.train.hyp_tuning import _take
    with torch.no_grad():
        for a, b in zip(t._trainable(), st.trainable):
            a.copy_(b[k])
    t.bn_state = _take(st.bn_state, k)
    for a, m, v in zip(t._trainable(), st.exp_avg, st.exp_avg_sq):
        t.optimizer.state[a] = {'step': torch.tensor(float(st.n_steps)),
                                'exp_avg': m[k].clone(), 'exp_avg_sq': v[k].clone()}
    t.n_steps = st.n_steps


def _hyp_synced_steps(joints, hyp, combos):
    """A stacked group's steps against its trials' own Trainers, each trial
    step taken from the stacked state before it, on the same rows and
    keep-masks: losses and gradient norms within HYP_STEP_TOL relative, the
    clipped gradients within HYP_GRAD_TOL of their global norm, and the
    weights after the update within 2 lr (Adam's first steps move an
    element by about lr whatever its gradient, so a gradient that is
    rounding noise, as the pre-BN biases' are, can move either way).
    Returns the worst deviations."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.models import n_dropout_sites, train_keep_masks
    from monoloco_tpu_torch.train import Trainer
    from monoloco_tpu_torch.train.hyp_tuning import StackedTrials
    args = run.cli(['train', '--joints', joints, '--monocular', '--no_save'])
    trainers = [Trainer(hyp._trial_args(args, c)) for c in combos]
    st = StackedTrials(trainers[0], combos)
    t0 = trainers[0]
    perm = t0._permutation(0)
    worst = {'loss': 0.0, 'grad_norm': 0.0, 'grads': 0.0, 'weights_over_lr': 0.0}
    steps = min(HYP_SYNC_STEPS, t0.n_train // t0.bs)      # full batches only
    check(steps > 0, f"hyp: {t0.n_train} rows, no full batch of {t0.bs}")
    for s in range(steps):
        idx = perm[s * t0.bs:(s + 1) * t0.bs]
        masks = train_keep_masks(idx.shape[0], t0.hidden_size, n_dropout_sites(t0.n_stage),
                                 t0.dropout, t0.gen, t0.device)
        for k, t in enumerate(trainers):
            _stacked_to_trainer(st, k, t)
        losses, gnorms = st.step(t0.x_tr[idx], t0.y_tr[idx], masks)
        for k, t in enumerate(trainers):
            lr = t.lr_at(t.n_steps)
            loss, gnorm, _ = t.step(t.x_tr[idx], t.y_tr[idx], masks)
            worst['loss'] = max(worst['loss'], abs(float(losses[k]) - float(loss))
                                / abs(float(loss)))
            worst['grad_norm'] = max(worst['grad_norm'], abs(float(gnorms[k]) - float(gnorm))
                                     / float(gnorm))
            clipped = min(float(gnorm), 3.0)           # the global norm after the clip
            for a, b in zip(t._trainable(), st.trainable):
                worst['grads'] = max(worst['grads'],
                                     float((a.grad - b.grad[k]).abs().max()) / clipped)
                worst['weights_over_lr'] = max(worst['weights_over_lr'],
                                               float((a.detach() - b.detach()[k]).abs().max())
                                               / lr)
    check(worst['loss'] <= HYP_STEP_TOL and worst['grad_norm'] <= HYP_STEP_TOL
          and worst['grads'] <= HYP_GRAD_TOL and worst['weights_over_lr'] <= 2.0,
          f"hyp: a stacked step off its trials' own steps: {worst}")
    return worst


def phase_hyp(tmp, joints):
    """HypTuning at the real search space (hidden 512/1024/2048, bs 64-1024,
    3 stages), multiplier 3, serial then stacked through `run train --hyp`;
    then the largest stacked group's steps against its trials' own, each
    from the stacked state (`_hyp_synced_steps`)."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.train import HypTuning
    banner(f"== phase 25: train --hyp on the card: multiplier {HYP_MULTIPLIER} "
           f"({6 * HYP_MULTIPLIER} trials), {HYP_EPOCHS} epochs a trial, serial then stacked",
           flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    work = os.path.join(tmp, 'hyp')
    os.makedirs(work, exist_ok=True)
    old = os.getcwd()
    os.chdir(work)
    argv = ['train', '--joints', joints, '--hyp', '--multiplier', str(HYP_MULTIPLIER),
            '--r_seed', str(HYP_SEED), '--epochs', str(HYP_EPOCHS), '--monocular']
    captured = {}
    real_train = HypTuning.train

    def keep(self, args):
        captured['hyp'] = self
        return real_train(self, args)

    HypTuning.train = keep
    try:
        hyp = HypTuning('x', HYP_EPOCHS, multiplier=HYP_MULTIPLIER, r_seed=HYP_SEED)
        groups = hyp.groups()
        sizes = {f'bs {k[0]} hidden {k[1]}': len(v) for k, v in groups.items()}
        print(f"groups (bs, hidden, 3 stages): {sizes}", flush=True)
        check(max(sizes.values()) >= 2, "no group stacks two trials")
        results, walls = {}, {}
        for path, flag in (('serial', '0'), ('stacked', '1')):
            os.environ['MONOLOCO_TPU_HYP_PARALLEL'] = flag
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best = run.main(argv)
            torch.cuda.synchronize()
            walls[path] = time.perf_counter() - t0
            results[path] = (best, captured['hyp'].trial_results)
    finally:
        HypTuning.train = real_train
        os.environ.pop('MONOLOCO_TPU_HYP_PARALLEL', None)
        os.chdir(old)
    acc = {p: np.asarray([r[0] for r in results[p][1]]) for p in results}
    rel = np.abs(acc['stacked'] - acc['serial']) / np.abs(acc['serial'])
    stacked_trials = [i for idxs in groups.values() if len(idxs) > 1 for i in idxs]
    largest = max(groups.values(), key=len)
    combos = hyp._trial_combos()
    worst = _hyp_synced_steps(joints, hyp, [combos[i] for i in largest])
    print(json.dumps({'phase': 25, 'trials': len(acc['serial']), 'wall_s': walls,
                      'best_val_d_serial': acc['serial'].tolist(),
                      'best_val_d_stacked': acc['stacked'].tolist(),
                      'free_running_rel_diff_stacked_trials': {
                          str(i): float(rel[i]) for i in stacked_trials},
                      'best_epochs': {p: [r[1] for r in results[p][1]] for p in results},
                      'winner': {p: {k: results[p][0].get(k) for k in
                                     ('lr', 'bs', 'hidden_size', 'acc_val', 'best_epoch')}
                                 for p in results},
                      'synced_steps': {'group': f'bs {combos[largest[0]]["bs"]} hidden '
                                                f'{combos[largest[0]]["hidden_size"]}',
                                       'trials': len(largest), 'steps': HYP_SYNC_STEPS,
                                       'max_rel_or_abs': worst}}), flush=True)
    single = [i for i in range(len(rel)) if i not in stacked_trials]
    check(np.all(np.isfinite(acc['serial'])) and np.all(np.isfinite(acc['stacked'])),
          "hyp: a trial's val d is not finite")
    # A group of one trains as its serial run; only the val d's sum differs
    # (evaluate()'s masked rows against val_metrics).
    check(all(rel[i] <= 1e-5 for i in single),
          "hyp: a group of one (the plain Trainer) is off its serial run")


def phase_full_volume(tmp, mode):
    """`tools.eval_parity --train` at the JAX package's full synthetic volume
    as a user runs it (its stages and legs in subprocesses); the float32 leg
    against the JAX package's ALE/ALP, int8 and bf16 against float32.
    Returns the legs' launch counts."""
    from monoloco_tpu_torch.tools import eval_parity
    ref = eval_parity.JAX_REFERENCE[mode]
    epochs = FULL_EPOCHS[mode]
    full = epochs == 500
    n_train, n_val = ((ref['n_train'], ref['n_val']) if full else
                      (STEREO_SMOKE_SCENES, STEREO_SMOKE_SCENES))
    banner(f"== phase {26 if mode == 'mono' else 27}: tools.eval_parity --train, {mode}, "
           f"{n_train} + {n_val} scenes, {epochs} epochs", flush=True)
    root = os.path.join(tmp, f'full_{mode}')
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    if full:
        rec = eval_parity.main([root, '--train', '--mode', mode, '--epochs', str(epochs)])
    else:
        # The path alone: the tool's stages and its float32 leg.
        t0 = time.perf_counter()
        model, rec = eval_parity.train_root(root, mode, n_train, n_val, epochs, 1, False)
        rec['legs'] = {'float32': eval_parity.run_leg(root, model, mode, 'float32', False)}
        rec.update(vs_jax=eval_parity.vs_jax(mode, rec['legs']['float32']),
                   ale_all_delta_pct={}, wall_s=time.perf_counter() - t0)
    legs, f32 = rec['legs'], rec['legs']['float32']
    busy, wall, _, _, _ = _busy_share_of_an_epoch(rec['joints'], mode)
    print(json.dumps({'phase': 26 if mode == 'mono' else 27, 'mode': mode, 'epochs': epochs,
                      'n_train_rows': rec['n_train_rows'], 'train_wall_s': rec['train_wall_s'],
                      'samples_per_s': rec['samples_per_s'], 'device': rec['device'],
                      'device_busy_share': busy / wall, 'best_epoch': rec['best_epoch'],
                      'float32': {'ale': f32['ale'], 'alp': f32['alp'],
                                  'matched': f32['matched']},
                      'vs_jax': rec['vs_jax'], 'jax_ale_all': ref['ale_all_mean'],
                      'jax_alp_1m': ref['alp_1m_mean'],
                      'ale_pct_vs_float32': rec['ale_all_delta_pct'],
                      'wall_s': rec['wall_s']}), flush=True)
    check(rec['device'].startswith('cuda'), f"{mode}: trained on {rec['device']}")
    check(f32['matched'] == ref['matched'] if full else f32['matched'] > 0,
          f"{mode}: {f32['matched']} matched rows, the JAX package {ref['matched']}")
    check(np.isfinite(f32['ale']['all']), f"{mode}: ALE {f32['ale']}")
    if full:
        check(abs(rec['vs_jax']['ale_all_pct']) <= FULL_ALE_PCT[mode]
              and abs(rec['vs_jax']['alp_1m_points']) <= FULL_ALP_POINTS,
              f"{mode}: float32 ALE/ALP outside the band of the JAX package's: "
              f"{rec['vs_jax']}")
    for p, kernel in (('int8', 'dyn8_mlp'), ('bf16', 'fused_mlp_bf16')):
        if p not in legs:
            continue
        leg = legs[p]
        alp = {g: leg['alp'][g] - f32['alp'][g] for g in f32['alp']}
        check(leg['launches'].get(kernel, 0) == leg['dispatches'] > 0,
              f"{mode} {p}: launches {leg['launches']} for {leg['dispatches']} dispatches")
        if full:
            check(abs(rec['ale_all_delta_pct'][p]) <= AB_ALE_PCT
                  and all(abs(v) <= AB_ALP_POINTS for v in alp.values()),
                  f"{mode} {p}: end metric outside 2% ALE / 1 point ALP of float32: "
                  f"{rec['ale_all_delta_pct'][p]}, {alp}")
    check(legs['float32']['launches'] == {}, "float32 leg launched a kernel")
    return {kernel: legs[p]['launches'].get(kernel, 0)
            for p, kernel in (('int8', 'dyn8_mlp'), ('bf16', 'fused_mlp_bf16')) if p in legs}


class _FakeCapture:
    """cv2.VideoCapture of WEBCAM_FRAMES random 480 x 640 frames."""

    def __init__(self, *_):
        self.frames_left = WEBCAM_FRAMES

    def isOpened(self):
        return True

    def read(self):
        if self.frames_left == 0:
            return False, None
        self.frames_left -= 1
        rng = np.random.RandomState(self.frames_left)
        return True, rng.randint(0, 255, (480, 640, 3), np.uint8)


def _webcam_stubs():
    """cv2 and openpifpaf stand-ins, as tests/test_webcam.py makes them: a
    capture of random frames, nearest resize, and one pose a frame (16 for
    every other frame, so the padded dispatch crosses the int8 floor)."""
    import types
    cv2 = types.ModuleType('cv2')
    cv2.VideoCapture = _FakeCapture
    cv2.COLOR_BGR2RGB = 4

    def resize(img, _none, fx=1.0, fy=1.0):
        h = max(1, int(round(img.shape[0] * fy)))
        w = max(1, int(round(img.shape[1] * fx)))
        ys = (np.arange(h) / fy).astype(int).clip(0, img.shape[0] - 1)
        xs = (np.arange(w) / fx).astype(int).clip(0, img.shape[1] - 1)
        return img[ys][:, xs]

    cv2.resize = resize
    cv2.cvtColor = lambda img, code: img[..., ::-1]

    class _Annotation:
        def __init__(self, data):
            self._data = data

        def json_data(self):
            return self._data

    class Predictor:
        calls = 0

        def __init__(self, checkpoint=None):
            pass

        def numpy_images(self, images):
            h, w = images[0].shape[:2]
            rng = np.random.RandomState(Predictor.calls)
            n = 16 if Predictor.calls % 2 else 1
            Predictor.calls += 1
            anns = []
            for _ in range(n):
                cx = w * rng.uniform(0.2, 0.8)
                kps = []
                for j in range(17):
                    kps += [float(cx + rng.uniform(-w * 0.05, w * 0.05)),
                            float(h * (0.2 + 0.6 * j / 16)), 0.9]
                anns.append({'keypoints': kps, 'bbox': [cx - w * 0.1, h * 0.15, w * 0.2, h * 0.7],
                             'score': 0.9})
            yield [_Annotation(a) for a in anns], None, None

    openpifpaf = types.ModuleType('openpifpaf')
    openpifpaf.Predictor = Predictor
    return cv2, openpifpaf


def phase_verticals(root, joints, model):
    """The eval verticals and the webcam loop through the entry point, on
    phase 21's tree with a hidden-1024 checkpoint trained on the card.
    Returns their launch counts."""
    import pickle
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.models import init_monoloco_params, save_checkpoint
    from monoloco_tpu_torch.ops import launches
    banner("== phase 28: eval --activity, --geometric, --variance, --generate --baselines, "
           "--save and predict --webcam through the entry point", flush=True)
    counts = {}
    old = os.getcwd()
    os.chdir(root)
    try:
        # prep --activity, then eval --activity --dataset kitti under int8.
        t0 = time.perf_counter()
        run.main(['prep', '--dir_ann', 'annotations', '--activity'])
        n_gt = len(os.listdir(os.path.join('data', 'kitti', 'gt_activity')))
        os.environ['MONOLOCO_TPU_PRECISION'] = 'int8'
        _zero_launches()
        ev = run.main(['eval', '--activity', '--dataset', 'kitti', '--dir_ann', 'annotations',
                       '--model', model])
        act = dict(launches)
        net = ev.monoloco
        acc = float(np.mean(np.asarray(ev.all_gt['all']) == np.asarray(ev.all_pred['all'])))
        print(json.dumps({'phase': 28, 'vertical': 'activity', 'gt_files': n_gt,
                          'matched': len(ev.all_gt['all']), 'accuracy': acc,
                          'dispatches': net.n_dispatches, 'dispatches_int8': net.n_dispatches_int8,
                          'launches': {k: v for k, v in act.items() if v},
                          'device': str(net.device), 'wall_s': time.perf_counter() - t0}),
              flush=True)
        check(net.device.type == 'cuda' and len(ev.all_gt['all']) > 0
              and act['dyn8_mlp'] == net.n_dispatches_int8 > 0,
              f"eval --activity: {net.n_dispatches_int8} int8 dispatches, launches {act}")
        counts['dyn8_mlp'] = act['dyn8_mlp']

        # --geometric and --variance on the prep joints (host numpy).
        t0 = time.perf_counter()
        errors = run.main(['eval', '--geometric', '--joints', joints['mono']])
        check(np.isfinite(errors['all']) and errors['all'] >= 0, f"eval --geometric: {errors}")
        with open(joints['stereo']) as f:
            jo = json.load(f)
        stem = os.path.join(root, 'variance_joints')
        for method in ('pifpaf', 'mask'):
            sub = {ph: {k: v[:2000] for k, v in jo[ph].items() if isinstance(v, list)}
                   for ph in ('train', 'val')}
            with open(f'{stem}_{method}.json', 'w') as f:
                json.dump(sub, f)
        dic_var = run.main(['eval', '--variance', '--joints', stem])
        rep = dic_var['pifpaf']['rep']
        print(json.dumps({'phase': 28, 'vertical': 'geometric and variance',
                          'geometric_error': errors, 'variance_rep': rep,
                          'wall_s': time.perf_counter() - t0}), flush=True)
        check(set(dic_var) == {'pifpaf', 'mask'} and rep and all(
            0 <= v <= 1 for v in rep.values()), f"eval --variance: {dic_var}")

        # eval --generate --baselines (mono) under int8, with a legacy net.
        params, bn = init_monoloco_params(SEED + 5, 34, 2, 256, 3)
        os.makedirs(os.path.join('data', 'models'), exist_ok=True)
        save_checkpoint(os.path.join('data', 'models', 'monoloco-190717-0952.pkl'), params, bn)
        _zero_launches()
        t0 = time.perf_counter()
        gen, ev = run.main(['eval', '--generate', '--baselines', '--dir_ann', 'annotations',
                            '--model', model])
        base = dict(launches)
        trees = {n: sorted(os.listdir(os.path.join('data', 'kitti', n)))
                 for n in ('monoloco_pp', 'monoloco', 'geometric')}
        print(json.dumps({'phase': 28, 'vertical': 'generate --baselines',
                          'files': {n: len(v) for n, v in trees.items()},
                          'methods_scored': ev.methods,
                          'dispatches': gen.model.n_dispatches,
                          'dispatches_int8': gen.model.n_dispatches_int8,
                          'legacy_dispatches': gen.monoloco.n_dispatches,
                          'launches': {k: v for k, v in base.items() if v},
                          'wall_s': time.perf_counter() - t0}), flush=True)
        check(trees['monoloco_pp'] and trees['monoloco_pp'] == trees['monoloco']
              == trees['geometric'], "generate --baselines: the trees differ")
        check(gen.monoloco.device.type == 'cuda'
              and base['dyn8_mlp'] == gen.model.n_dispatches_int8 > 0,
              f"generate --baselines: launches {base}")
        check({'monoloco_pp', 'monoloco', 'geometric'} <= set(ev.methods),
              f"generate --baselines: EvalKitti scored {ev.methods}")
        counts['dyn8_mlp'] += base['dyn8_mlp']

        # eval --save: the figures need matplotlib.
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        if has_mpl:
            run.main(['eval', '--save'])
            figs = sorted(os.listdir(os.path.join('figures', 'results')))
            check(figs == ['results_monoloco_pp.png', 'spread_monoloco_pp.png',
                           'task_error.png'], f"eval --save wrote {figs}")
            print(f"eval --save: {figs}", flush=True)
        else:
            try:
                run.main(['eval', '--save'])
                fail("eval --save ran without matplotlib")
            except SystemExit as exc:
                check('matplotlib' in str(exc.code), f"eval --save: {exc.code}")
                print(f"eval --save without matplotlib exits: {exc.code}", flush=True)
    finally:
        os.chdir(old)

    # predict --webcam over WEBCAM_FRAMES frames, headless, json outputs.
    work = os.path.join(root, 'webcam')
    os.makedirs(work, exist_ok=True)
    saved = {k: sys.modules.get(k) for k in ('cv2', 'openpifpaf')}
    sys.modules['cv2'], sys.modules['openpifpaf'] = _webcam_stubs()
    os.chdir(work)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'int8'
    _zero_launches()
    try:
        t0 = time.perf_counter()
        net, frames = run.main(['predict', '--webcam', '--model', model, '--output_types',
                                'json', '--activities', 'social_distance', 'raise_hand'])
        wall = time.perf_counter() - t0
        cam = dict(launches)
        outs = sorted(os.listdir('.'))
        with open('out_webcam_1.monoloco.json') as f:
            one = json.load(f)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        os.chdir(old)
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    print(json.dumps({'phase': 28, 'vertical': 'webcam', 'frames': frames, 'files': len(outs),
                      'dispatches': net.n_dispatches, 'dispatches_int8': net.n_dispatches_int8,
                      'launches': {k: v for k, v in cam.items() if v}, 'device': str(net.device),
                      'wall_s': wall, 'frames_per_s': frames / wall}), flush=True)
    check(frames == WEBCAM_FRAMES and net.device.type == 'cuda'
          and outs == [f'out_webcam_{i}.monoloco.json' for i in range(WEBCAM_FRAMES)],
          f"webcam: {frames} frames, files {outs}")
    check(len(one['dds_pred']) == 16 and all(np.isfinite(one['dds_pred']))
          and cam['dyn8_mlp'] == net.n_dispatches_int8 > 0,
          f"webcam: launches {cam}, {len(one['dds_pred'])} detections")
    counts['dyn8_mlp'] += cam['dyn8_mlp']
    return counts


REID_CROPS = 64            # phase 29: crops a batch, 32 from each fixture image
REID_REPS = 10             # phase 29: timed batches
REID_TOL = 1e-4            # phase 29: card vs CPU ResNet-50 features, of max |feature|
TINY_REID_TOL = 1e-5       # phase 29: card vs CPU tiny features, max abs
BASELINE_SCENES, BASELINE_SEED = 64, 30     # phase 30: val scenes of the stereo tree
MESH_TREE_SCENES, MESH_SEED = 128, 31       # phase 31: val scenes of the generation tree
MESH_TRAIN_EPOCHS = 2
MESH_TRAIN_RTOL = 1e-5     # phase 31: val losses, a mesh against none (one card: bit equal)
MESH_SERVE_REQUESTS = 8
MESH_SERVE_TOL = 1e-5      # phase 31: (1 + |ref|)
TINY_REID = os.path.join(REPO, 'tests', 'fixture_tiny_reid.pkl')


def _reid_crops():
    """REID_CROPS person-shaped crops (uint8) from the left and right
    fixture images, decoded and cropped by the port's image module, from a
    numpy seed."""
    from monoloco_tpu_torch.utils.image import crop, read_png_rgb
    rng = np.random.default_rng(SEED + 29)
    crops = []
    for name in ('fixture_000840.png', 'fixture_000840_right.png'):
        image = read_png_rgb(os.path.join(REPO, 'tests', name))
        for _ in range(REID_CROPS // 2):
            w = rng.uniform(20, 160)
            h = min(w * rng.uniform(1.8, 2.8), 370.0)
            x0, y0 = rng.uniform(0, 1238 - w), rng.uniform(0, 374 - h)
            crops.append(crop(image, (x0, y0, x0 + w, y0 + h)))
    return crops


def _cuda_ms(fn, reps):
    """Median ms of fn() over reps, each between CUDA events, after one warm
    call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_reid(smi):
    """The ReID nets on the card against the CPU, timed."""
    import warnings
    from monoloco_tpu_torch.eval.reid_baseline import ReID
    banner(f"== phase 29: ReID ResNet-50 at 256x128 ({REID_CROPS} crops of the fixture pair, "
           f"weights from init_resnet50(seed 1)) and the tiny net, card vs CPU")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    crops = _reid_crops()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)     # random weights, on purpose
        nets = {dev: ReID(weights_path=None, device=dev) for dev in ('cuda', 'cpu')}
    t0 = time.perf_counter()
    feats = {dev: net.forward(crops) for dev, net in nets.items()}
    x = nets['cuda']._preprocess(crops)
    with torch.inference_mode():
        ms = _cuda_ms(lambda: nets['cuda'].net(x), REID_REPS)
    t1 = time.perf_counter()
    nets['cuda'].forward(crops)
    forward_s = time.perf_counter() - t1
    err = float(np.abs(feats['cuda'] - feats['cpu']).max())
    scale = float(np.abs(feats['cpu']).max())
    print(json.dumps({'phase': 29, 'net': 'resnet50', 'crops': REID_CROPS, 'hw': [256, 128],
                      'features': list(feats['cuda'].shape), 'max_abs_err': err,
                      'max_abs_feature': scale, 'net_ms_per_batch': ms,
                      'net_crops_per_s': REID_CROPS / ms * 1e3,
                      'forward_s_with_host_resize': forward_s,
                      'crops_per_s_with_host_resize': REID_CROPS / forward_s,
                      'wall_s': time.perf_counter() - t0, 'device': smi}), flush=True)
    check(feats['cuda'].shape == (REID_CROPS, 2048) and np.isfinite(feats['cuda']).all(),
          "ResNet-50 features: shape or finiteness")
    check(err <= REID_TOL * scale, f"ResNet-50 card vs CPU: {err} > {REID_TOL} x {scale}")
    tiny = {dev: ReID(weights_path=TINY_REID, device=dev) for dev in ('cuda', 'cpu')}
    t_feats = {dev: net.forward(crops) for dev, net in tiny.items()}
    x = tiny['cuda']._preprocess(crops)
    with torch.inference_mode():
        t_ms = _cuda_ms(lambda: tiny['cuda'].net(x), REID_REPS)
    t_err = float(np.abs(t_feats['cuda'] - t_feats['cpu']).max())
    print(json.dumps({'phase': 29, 'net': 'tiny', 'hw': [64, 32], 'max_abs_err': t_err,
                      'net_ms_per_batch': t_ms, 'net_crops_per_s': REID_CROPS / t_ms * 1e3}),
          flush=True)
    check(t_err <= TINY_REID_TOL, f"tiny ReID card vs CPU: {t_err}")


def _facing(params, bn_state):
    """A copy of MonStereo weights whose output biases put theta = psi =
    pi/2: with random weights z otherwise sits near 0, where the position
    magnifies the last bit of the net's outputs (phase 9's weights have only
    the distance at 15 m)."""
    params = {k: dict(v) if k == 'w_fin' else v for k, v in params.items()}
    params['w_fin']['b'] = params['w_fin']['b'].clone()
    params['w_fin']['b'][0:2] += np.pi / 2
    return params, bn_state


def _stereo_tree(root, scenes, seed, images):
    """An easy-mode synthetic KITTI tree (identity-textured left and right
    images when `images`) at root, made the working directory."""
    from monoloco_tpu_torch.tools.make_synthetic_kitti import make_dataset
    make_dataset(root, n_train=2, n_val=scenes, seed=seed, images=images)
    os.chdir(root)


def _read_rows(tree):
    rows = {}
    for name in sorted(os.listdir(tree)):
        with open(os.path.join(tree, name)) as f:
            rows[name] = [line.split() for line in f]
    return rows


def _rows_close(a, b, tol):
    """Same files and rows, the text and box columns equal, and the
    position (x, y, z, columns 11-13) within tol (1 + |b|). Returns the
    largest difference of each float column, of (1 + |b|): the angles'
    columns magnify the last bit of a random net's outputs (atan2 near z = 0
    of the raw orientation), so they are printed, not held."""
    check(list(a) == list(b), "the trees hold other files")
    worst = np.zeros(15)
    for name in a:
        check(len(a[name]) == len(b[name]), f"{name}: row counts differ")
        for ra, rb in zip(a[name], b[name]):
            check(ra[:3] == rb[:3] and ra[4:8] == rb[4:8], f"{name}: text or box columns differ")
            fa, fb = np.array(ra[3:], float), np.array(rb[3:], float)
            worst = np.maximum(worst, np.abs(fa - fb) / (1 + np.abs(fb)))
    xyz = float(worst[11 - 3:14 - 3].max())
    check(xyz <= tol, f"positions differ by {xyz} > {tol}")
    return {col: float(worst[col - 3]) for col in range(3, 18)}


def phase_stereo_baselines(tmp, s_params, s_bn):
    """`eval --generate --baselines --mode stereo` through the entry point:
    float32, int8 and bf16 runs (launches counted), and a float32 run
    without --baselines. Returns the main-path launches."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.eval import GenerateKitti
    from monoloco_tpu_torch.models import init_monoloco_params, save_checkpoint
    from monoloco_tpu_torch.ops import launches
    banner(f"== phase 30: eval --generate --baselines --mode stereo, {BASELINE_SCENES} scenes "
           f"with right images, MonStereo at full width, the tiny ReID (--reid_weights)")
    old = os.getcwd()
    root = os.path.join(tmp, 'stereo_baselines')
    counts = {}
    try:
        t0 = time.perf_counter()
        _stereo_tree(root, BASELINE_SCENES, BASELINE_SEED, images=True)
        os.makedirs(os.path.join('data', 'models'), exist_ok=True)
        save_checkpoint(GenerateKitti.monoloco_checkpoint, *init_monoloco_params(0, 34, 2, 256, 3))
        save_checkpoint('monstereo.pkl', *_facing(s_params, s_bn))
        print(f"tree and checkpoints in {time.perf_counter() - t0:.1f} s", flush=True)
        argv = ['eval', '--generate', '--mode', 'stereo', '--dir_ann', 'annotations', '--model',
                'monstereo.pkl', '--hidden_size', str(HIDDEN), '--n_stage', str(STAGES)]
        trees = {}
        for precision, baselines in (('float32', False), ('float32', True), ('int8', True),
                                     ('bf16', True)):
            os.environ['MONOLOCO_TPU_PRECISION'] = precision
            extra = ['--baselines', '--reid_weights', TINY_REID] if baselines else []
            _zero_launches()
            t1 = time.perf_counter()
            gen, ev = run.main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            ran = {k: n for k, n in launches.items() if n}
            key = precision + ('_baselines' if baselines else '')
            methods = ('monstereo', 'monoloco', 'geometric', 'pose', 'reid') if baselines \
                else ('monstereo',)
            trees[key] = {m: _read_rows(os.path.join('data', 'kitti', m)) for m in methods}
            rec = {'phase': 30, 'precision': precision, 'baselines': baselines,
                   'images': len(trees[key]['monstereo']), 'wall_s': wall,
                   'images_per_s': len(trees[key]['monstereo']) / wall,
                   'dispatches': gen.model.n_dispatches,
                   'dispatches_int8': gen.model.n_dispatches_int8, 'launches': ran}
            if baselines:
                n_ann = sum(len(r) for r in trees[key]['monstereo'].values())
                rec['stereo_corrected_pct'] = {k: gen.cnt_disparity[k] / max(n_ann, 1) * 100
                                               for k in gen.stereo_baselines}
                rec['no_stereo'] = gen.cnt_no_stereo
                check(set(methods) <= set(ev.methods), f"EvalKitti scored {ev.methods}")
                check(gen.reid_net.pretrained and gen.reid_net.device.type == 'cuda',
                      "the ReID net is not the tiny one on the card")
                counts = {k: counts.get(k, 0) + n for k, n in ran.items()}
            print(json.dumps(rec), flush=True)
            for m in methods:
                check(len(trees[key][m]) == BASELINE_SCENES, f"{key}: {m} has "
                                                             f"{len(trees[key][m])} files")
            kernel = {'int8': 'dyn8_mlp', 'bf16': 'fused_mlp_bf16'}.get(precision)
            check(ran.get(kernel, 0) > 0 if kernel else not ran,
                  f"{key}: launches {ran}")
        worst = _rows_close(trees['float32_baselines']['monstereo'],
                            trees['float32']['monstereo'], 1e-5)
        print(f"monstereo with --baselines (one dispatch an image) against without (64-image "
              f"chunks), float32: largest difference of (1 + |x|) by column {worst}")

        def mean_rel(tree, ref):
            d = np.concatenate([[np.linalg.norm(np.array(r[11:14], float)) for r in tree[n]]
                                for n in tree])
            d_ref = np.concatenate([[np.linalg.norm(np.array(r[11:14], float)) for r in ref[n]]
                                    for n in ref])
            return float(np.abs(d - d_ref).mean() / np.abs(d_ref).mean())

        for precision in ('int8', 'bf16'):
            for m in ('reid', 'monstereo'):
                rel = mean_rel(trees[f'{precision}_baselines'][m],
                               trees['float32_baselines'][m])
                print(f"{precision} against float32, {m} tree: distance mean relative "
                      f"{rel:.3e} (budget {DYN8_BUDGET})")
                check(rel < DYN8_BUDGET, f"{precision} {m} tree outside the budget")
    finally:
        os.chdir(old)
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    return counts


def _serve_mesh(model, n, requests):
    """`python -m monoloco_tpu_torch.serve --dp_devices n` on `model`: the
    responses to `requests` (keypoints lists), in order."""
    import re
    import signal
    import threading
    import urllib.request
    proc = subprocess.Popen([sys.executable, '-m', 'monoloco_tpu_torch.serve', '--model', model,
                             '--port', '0', '--dp_devices', str(n)], cwd=REPO,
                            env=dict(os.environ, MONOLOCO_TPU_PRECISION='float32'),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, serving = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith('serving '):
                serving.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not serving.wait(180):
            fail(f"serve --dp_devices {n} printed no 'serving' line: {lines[-20:]}")
        print(lines[-1], flush=True)
        port = int(re.search(r'http://[^:]+:(\d+)', lines[-1]).group(1))
        kk = [[718.0, 0.0, 600.0], [0.0, 718.0, 180.0], [0.0, 0.0, 1.0]]
        out = []
        for kps in requests:
            req = urllib.request.Request(f'http://127.0.0.1:{port}/v1/predict',
                                         data=json.dumps({'keypoints': kps, 'kk': kk}).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                out.append(json.loads(resp.read())['outputs'])
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(30)
        check(code == 0, f"serve --dp_devices {n} exited {code}: {lines[-20:]}")
        return out, kk
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)


def _val_logs(trainer):
    """(epochs, 1 + tasks) val losses of each epoch: what every rank of a
    mesh computed, kept by rank 0's Trainer after the group is gone."""
    names = ['all'] + list(trainer.tasks)
    return np.array([trainer.epoch_losses['val'][k] for k in names]).T


def phase_meshes(tmp, joints, model, s_params, s_bn):
    """Every mesh entry point over an NCCL world of torch.cuda.device_count()
    ranks against the run without a mesh. Returns the main-path launches."""
    from monoloco_tpu_torch import run
    from monoloco_tpu_torch.models import save_checkpoint
    from monoloco_tpu_torch.network import Loco
    from monoloco_tpu_torch.ops import launches
    from monoloco_tpu_torch.parallel.dryrun import dryrun_multichip
    n = torch.cuda.device_count()
    banner(f"== phase 31: device meshes over NCCL, dp{n} (torch.cuda.device_count() = {n})")
    print(f"NCCL takes one rank a card, so this machine's mesh is dp{n}; the equalities of "
          f"several ranks (dp2, dp2 x tp2) are held on the CPU over gloo by "
          f"tests/test_torch_parallel.py", flush=True)
    os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    counts = {}
    t0 = time.perf_counter()
    runs = {}
    for key, extra in (('none', []), ('mesh', ['--dp_devices', str(n)])):
        t1 = time.perf_counter()
        trainer = run.main(_train_args(joints['mono'], 'mono', (
            '--epochs', str(MESH_TRAIN_EPOCHS), '--no_save', *extra)))
        runs[key] = (_val_logs(trainer), time.perf_counter() - t1, trainer)
    val, val_ref = runs['mesh'][0], runs['none'][0]
    rel = float(np.max(np.abs(val - val_ref) / np.abs(val_ref)))
    print(json.dumps({'phase': 31, 'path': 'run train', 'dp': n, 'epochs': MESH_TRAIN_EPOCHS,
                      'val_max_rel_vs_no_mesh': rel, 'wall_s_mesh': runs['mesh'][1],
                      'wall_s_no_mesh': runs['none'][1]}), flush=True)
    check(runs['mesh'][2].device.type == 'cuda', "the mesh trained off the card")
    check(rel <= (MESH_TRAIN_RTOL if n == 1 else 2e-3), f"train on the mesh: val {rel}")
    old = os.getcwd()
    try:
        _stereo_tree(os.path.join(tmp, 'mesh_tree'), MESH_TREE_SCENES, MESH_SEED, images=False)
        save_checkpoint('monstereo.pkl', *_facing(s_params, s_bn))
        for mode, ckpt in (('mono', model), ('stereo', 'monstereo.pkl')):
            for precision in ('float32', 'int8'):
                os.environ['MONOLOCO_TPU_PRECISION'] = precision
                trees = {}
                for key, extra in (('none', []), ('mesh', ['--dp_devices', str(n)])):
                    _zero_launches()
                    t1 = time.perf_counter()
                    gen, _ = run.main(['eval', '--generate', '--mode', mode, '--dir_ann',
                                       'annotations', '--model', ckpt, *extra])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                    ran = {k: c for k, c in launches.items() if c}
                    if key == 'mesh':
                        counts = {k: counts.get(k, 0) + c for k, c in ran.items()}
                        check(gen.model.mesh is not None and gen.model.mesh.dp == n,
                              "generation ran without the mesh")
                    tree = os.path.join('data', 'kitti', gen.net)
                    trees[key] = {f: open(os.path.join(tree, f), 'rb').read()
                                  for f in sorted(os.listdir(tree))}
                    print(json.dumps({'phase': 31, 'path': 'eval --generate', 'mode': mode,
                                      'precision': precision, 'mesh': key, 'wall_s': wall,
                                      'images_per_s': len(trees[key]) / wall,
                                      'dispatches': gen.model.n_dispatches,
                                      'dispatches_int8': gen.model.n_dispatches_int8,
                                      'launches': ran}), flush=True)
                check(trees['mesh'] == trees['none'] and len(trees['none']) == MESH_TREE_SCENES,
                      f"{mode} {precision}: the mesh's txts differ from the run without one")
                print(f"{mode} {precision}: {len(trees['none'])} txts byte-equal", flush=True)
    finally:
        os.chdir(old)
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
    rng = np.random.default_rng(SEED + 31)
    requests = [(rng.random((m, 3, 17)) * 300).tolist() for m in (1, 3, 5, 8, 13, 16, 2, 7)]
    t1 = time.perf_counter()
    responses, kk = _serve_mesh(model, n, requests[:MESH_SERVE_REQUESTS])
    single = Loco(model=model, device='cuda')
    worst = 0.0
    for kps, out in zip(requests, responses):
        ref = single.forward_batch([np.asarray(kps, np.float32)], [kk])[0]
        for key in ('xyzd', 'bi', 'h', 'w', 'l'):
            got, want = np.asarray(out[key], np.float64), np.asarray(ref[key], np.float64)
            worst = max(worst, float((np.abs(got - want) / (1 + np.abs(want))).max()))
    print(json.dumps({'phase': 31, 'path': 'serve', 'dp': n, 'requests': len(responses),
                      'max_rel_vs_no_mesh': worst,
                      'wall_s': time.perf_counter() - t1}), flush=True)
    check(worst <= MESH_SERVE_TOL, f"serve --dp_devices {n}: {worst}")
    line = dryrun_multichip(n)
    check(f'dp{n}' in line and 'train step ok (hidden 1024, 3 stages' in line,
          f"dryrun_multichip({n}): {line}")
    if n >= 4:
        os.environ['MONOLOCO_TPU_PRECISION'] = 'float32'
        trainer = run.main(_train_args(joints['mono'], 'mono', (
            '--epochs', str(MESH_TRAIN_EPOCHS), '--no_save', '--dp_devices', '2',
            '--tp_devices', '2')))
        rel = float(np.max(np.abs(_val_logs(trainer) - val_ref) / np.abs(val_ref)))
        print(json.dumps({'phase': 31, 'path': 'run train dp2xtp2', 'val_max_rel_vs_no_mesh':
                          rel}), flush=True)
        check(rel <= 2e-3, f"train dp2 x tp2: val {rel}")
    print(f"phase 31: {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def _to_cuda(tree):
    return {k: _to_cuda(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cuda()


RULES = {'fused_mlp_bf16': 'bf16', 'fused_mlp_f32': 'f32', 'int8_static_mlp': 'int8',
         'w8_mlp': 'bf16'}
REPLACES = {'dyn8_mlp': 'monoloco_tpu/ops/fused_mlp.py:474',
            'relu_chain_bf16': 'tools/bench_roofline.py:100 (bench_chain_resident)',
            'fused_mlp_bf16': 'monoloco_tpu/ops/fused_mlp.py:63',
            'fused_mlp_f32': 'monoloco_tpu/ops/fused_mlp.py:63',
            'int8_static_mlp': 'monoloco_tpu/ops/fused_mlp.py:367',
            'w8_mlp': 'monoloco_tpu/ops/fused_mlp.py:367'}
SOURCES = {'dyn8_mlp': 'wgmma_layer_kmajor.cu', 'fused_mlp_bf16': 'wgmma_layer.cu',
           'relu_chain_bf16': 'relu_chain.cu',
           'fused_mlp_f32': 'wgmma_layer_kmajor.cu', 'int8_static_mlp': 'wgmma_layer_kmajor.cu',
           'w8_mlp': 'wgmma_layer.cu'}
# The type of each kernel's products and how many passes of them it makes
# (its bound), and the torch.matmul MLP that computes the same function
# (library_ms), where there is one.
OP_TYPE = {'dyn8_mlp': ('int8', 1), 'fused_mlp_bf16': ('bf16', 1), 'fused_mlp_f32': ('tf32', 3),
           'int8_static_mlp': ('int8', 1), 'w8_mlp': ('bf16', 1)}
LIBRARY = {'fused_mlp_bf16': 'bf16 folded (torch.matmul)',
           'relu_chain_bf16': 'relu chain (torch.matmul)',
           'fused_mlp_f32': 'f32 folded (torch.matmul)',
           'w8_mlp': 'bf16 folded (torch.matmul)'}


def make_kernels(folded, calib):
    """kernel name -> (entry(packed, x), plain(packed, x), packed)."""
    from monoloco_tpu_torch import ops
    w8 = ops.pack_folded_weights_w8(folded)
    return {
        'dyn8_mlp': (ops.fused_loco_forward_dyn8_auto, ops.dyn8_forward_plain, w8),
        'fused_mlp_bf16': (lambda p, x: ops.fused_loco_forward(None, x, packed=p),
                           ops.fused_forward_plain, ops.pack_folded_weights(folded)),
        'fused_mlp_f32': (lambda p, x: ops.fused_loco_forward(None, x, packed=p),
                          ops.fused_forward_plain,
                          ops.pack_folded_weights(folded, torch.float32)),
        'int8_static_mlp': (ops.fused_loco_forward_int8, ops.int8_static_forward_plain,
                            ops.pack_folded_weights_int8(folded, calib)),
        'w8_mlp': (ops.fused_loco_forward_w8, ops.w8_forward_plain, w8),
    }


def run_training_and_verticals(tmp, prep_root, joints, main_launches):
    """Phases 24-28, their launches added to `main_launches`."""
    t0 = time.perf_counter()
    model = phase_resume(tmp, joints['mono'])
    phase_hyp(tmp, joints['mono'])
    for mode in ('mono', 'stereo'):
        for key, n in phase_full_volume(tmp, mode).items():
            main_launches[key] = main_launches.get(key, 0) + n
    for key, n in phase_verticals(prep_root, joints, model).items():
        main_launches[key] = main_launches.get(key, 0) + n
    print(f"phases 24-28: {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        import monoloco_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the root of a monoloco_tpu checkout ({exc})")
    check('jax' not in sys.modules, "jax was imported")
    from monoloco_tpu_torch.models import fold_eval_params, init_loco_params
    from monoloco_tpu_torch.ops import pack_folded_weights_w8
    from monoloco_tpu_torch.ops.quant import synthetic_calibration_inputs

    smi = phase_device()
    params, bn_state = make_weights()
    folded = fold_eval_params(_to_cuda(params), _to_cuda(bn_state))
    kernels = make_kernels(folded, synthetic_calibration_inputs(IN_DIM, n=4096, device='cuda'))
    packed = kernels['dyn8_mlp'][2]
    max_err = {'dyn8_mlp': phase_kernel(packed, M_ROWS)}
    phase_rows(packed)
    # Phase 4's checkpoint, images and outputs, which phases 12-14 reuse.
    main_dir = tempfile.TemporaryDirectory()
    main_launches = phase_main_path(params, bn_state, main_dir.name)
    phase_reference()
    med = phase_times(kernels, folded, smi)
    s_params, s_bn = init_loco_params(SEED + 2, 68, 10, HIDDEN, STAGES)
    s_folded = fold_eval_params(_to_cuda(s_params), _to_cuda(s_bn))
    s_calib = torch.from_numpy(np.random.default_rng(SEED + 3).normal(
        size=(4096, 68)).astype(np.float32)).cuda()
    stereo = {name: (*kern, s_folded) for name, kern in make_kernels(s_folded, s_calib).items()}
    max_err.update(phase_new_kernels(kernels, folded, stereo))
    max_err['relu_chain_bf16'] = phase_relu_chain()
    for key, n in phase_bench().items():
        main_launches[key] = main_launches.get(key, 0) + n
    # MonStereo at full width, the weights of the stereo main path.
    m_params, m_bn = make_weights(STEREO_IN, STEREO_OUT, SEED + 2)
    with tempfile.TemporaryDirectory() as tmp:
        main_launches['dyn8_mlp'] += phase_stereo(m_params, m_bn, tmp)['dyn8_mlp']
    m_folded = fold_eval_params(_to_cuda(m_params), _to_cuda(m_bn))
    max_err['dyn8_mlp'] = max(max_err['dyn8_mlp'],
                              phase_dyn8_stereo(pack_folded_weights_w8(m_folded), m_folded))
    main_launches['relu_chain_bf16'] = phase_roofline()['relu_chain_bf16']
    f32_dicts, f32_epi, mc_launches = phase_mc(main_dir.name)
    for counts in (mc_launches, phase_precisions(main_dir.name, f32_dicts, f32_epi,
                                                 kernels['dyn8_mlp'])):
        for key, n in counts.items():
            main_launches[key] = main_launches.get(key, 0) + n
    phase_keypoints_profile(main_dir.name)
    phase_serve_entry(main_dir.name)
    for counts in (phase_serve_kernels(main_dir.name, m_params, m_bn), phase_serve_tools()):
        for key, n in counts.items():
            main_launches[key] = main_launches.get(key, 0) + n
    model = _main_model(main_dir.name)
    gen_root, gen_counts = phase_generate(main_dir.name, model, m_params, m_bn)
    for key, n in phase_generate_chunk(gen_root, model, kernels, folded).items():
        max_err[key] = max(max_err[key], n)
    for counts in (gen_counts, phase_int8_ab(main_dir.name)):
        for key, n in counts.items():
            main_launches[key] = main_launches.get(key, 0) + n
    # Prep, training and the trained checkpoint's ALE/ALP (phases 21-23).
    t0 = time.perf_counter()
    prep_root, joints = phase_prep(main_dir.name)
    phase_trained_eval(prep_root, phase_train(main_dir.name, joints))
    print(f"phases 21-23: {time.perf_counter() - t0:.1f} s", flush=True)
    # The rest of training and the eval verticals (phases 24-28).
    run_training_and_verticals(main_dir.name, prep_root, joints, main_launches)
    # The ReID net, the stereo baselines and the meshes (phases 29-31).
    t0 = time.perf_counter()
    phase_reid(smi)
    for counts in (phase_stereo_baselines(main_dir.name, m_params, m_bn),
                   phase_meshes(main_dir.name, joints, model, m_params, m_bn)):
        for key, n in counts.items():
            main_launches[key] = main_launches.get(key, 0) + n
    print(f"phases 29-31: {time.perf_counter() - t0:.1f} s", flush=True)
    main_dir.cleanup()
    check('jax' not in sys.modules, "jax was imported")
    names = list(kernels) + ['relu_chain_bf16']
    missing = [k for k in names if main_launches.get(k, 0) == 0]
    check(not missing, f"the main path never launched {missing}")

    kernel_lines = []
    for name in names:
        if name == 'relu_chain_bf16':
            bound_ms, bound_by = chain_bound(TIMING_ROWS)
        else:
            bound_ms, bound_by = bound(name, kernels[name][2], TIMING_ROWS)
        kernel_lines.append({
            "name": name, "route": "cuda",
            "source": f"monoloco_tpu_torch/ops/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name],
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": med[f'{name} kernel'], "plain_ms": med[f'{name} plain'],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": med[LIBRARY[name]] if name in LIBRARY else None})
    report = {"kernels": kernel_lines,
              "f32_matmul_ms": med['f32 folded (torch.matmul)'],
              "bf16_matmul_ms": med['bf16 folded (torch.matmul)']}
    print(f"nvidia-smi: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
