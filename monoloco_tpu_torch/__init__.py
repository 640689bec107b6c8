"""monoloco_tpu_torch — the PyTorch/CUDA port of monoloco_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports torch and numpy only, never jax. It runs predict (mono
and stereo: pifpaf keypoints -> K^-1 normalization -> the BN-folded residual
MLP -> decode -> post-processing -> `.monoloco.json`), the micro-batching
server, and KITTI txt generation and ALE/ALP evaluation (`run eval`), with
the MLP under MONOLOCO_TPU_PRECISION=int8 or bf16 running hand-written CUDA
kernels for Hopper (ops/csrc/wgmma_layer_kmajor.cu and wgmma_layer.cu). See
ROADMAP.md for what is not ported yet.
"""

__version__ = "0.1.0"
