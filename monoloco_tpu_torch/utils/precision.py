"""Serving precision knob, with the JAX package's spellings.

MONOLOCO_TPU_PRECISION selects how the folded MLP is served:
  default          plain f32 `torch.matmul` (what the JAX package serves off
                   the TPU, where XLA's default dot is full f32);
  float32 / f32 / fp32 / highest
                   the same, spelled as a pin;
  int8             the fused dynamic-int8 kernel (ops/fused_mlp.py) for
                   dispatches of at least engine._INT8_MIN_ROWS padded rows,
                   f32 below that;
  int8-a8 / int8-xla
                   the default path: they name the bench's static int8
                   ablations, and the JAX engine serves its default path
                   under both;
  bfloat16 / bf16  each product's operands rounded to bf16, the products
                   summed in f32, biases and the residual f32: the K1-bf16
                   kernel (ops/fused_mlp.py `fused_loco_forward` on a bf16
                   pack) for Loco nets of hidden % 128 == 0, `torch.matmul` on
                   bf16-rounded operands with TF32 off for the others. This is
                   the arithmetic of `jax.default_matmul_precision('bfloat16')`
                   on a GPU, where the JAX package keeps its weights f32;
  tensorfloat32    the f32 MLP with TF32 switched on around its products only
                   (`tf32_matmuls`).
Any other value raises.

MONOLOCO_TPU_SERVE_STORAGE takes the JAX package's spellings auto|f32|bf16
and raises on any other. Off the TPU it always resolves to f32 storage, as in
the JAX package (`serve_storage`): the bf16 route above rounds the operands
of each product, it does not store the folded weights in bf16.

Unlike the JAX package, which reads the variables once at import, the port
reads them when an engine is built, so one process can build engines at two
precisions.

TF32 is switched off for matmuls and convolutions when this module is
imported: the 3x3 K^-1 back-projection needs full f32 (a 1e-3 relative error
on a pixel coordinate is about 2 cm), as the JAX package pins HIGHEST there.
"""

import contextlib
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_SPELLINGS = {'default': 'default', 'int8-a8': 'default', 'int8-xla': 'default',
              'float32': 'float32', 'f32': 'float32', 'fp32': 'float32',
              'highest': 'float32', 'int8': 'int8',
              'bf16': 'bfloat16', 'bfloat16': 'bfloat16',
              'tensorfloat32': 'tensorfloat32'}
_STORAGES = ('auto', 'f32', 'bf16')


def serving_precision():
    """The canonical precision named by MONOLOCO_TPU_PRECISION (default
    'default'); raises ValueError on a spelling the port does not serve."""
    raw = os.environ.get('MONOLOCO_TPU_PRECISION', 'default')
    if raw not in _SPELLINGS:
        raise ValueError(
            f"MONOLOCO_TPU_PRECISION={raw!r}: the torch port serves "
            f"{sorted(_SPELLINGS)}")
    return _SPELLINGS[raw]


def serve_storage():
    """The served weights' storage under MONOLOCO_TPU_SERVE_STORAGE (default
    'auto'): always 'f32' off the TPU, as in the JAX package; raises
    ValueError with the JAX message on any spelling but auto|f32|bf16."""
    raw = os.environ.get('MONOLOCO_TPU_SERVE_STORAGE', 'auto')
    if raw not in _STORAGES:
        raise ValueError(f"MONOLOCO_TPU_SERVE_STORAGE={raw!r}: use auto|f32|bf16")
    return 'f32'


@contextlib.contextmanager
def tf32_matmuls():
    """TF32 on for CUDA matmuls inside the block, restored after it (also
    when the block raises)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
