"""monoloco_tpu_torch — the PyTorch/CUDA port of monoloco_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports torch and numpy only, never jax. This slice serves mono
prediction (MonoLoco++): pifpaf keypoints -> K^-1 normalization -> the
BN-folded residual MLP -> decode -> post-processing -> `.monoloco.json`,
with the MLP under MONOLOCO_TPU_PRECISION=int8 running a hand-written CUDA
kernel for Hopper (ops/csrc/dyn8_mlp.cu). See ROADMAP.md for what is not
ported yet.
"""

__version__ = "0.1.0"
