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
                   under both.
bf16, bfloat16 and tensorfloat32 raise: they go with the bf16 weight storage
route, which comes with serving (ROADMAP Queue 1 item 3). Any other value
raises too. Weight storage is always f32: the JAX package casts its served
weights to bf16 only on a TPU.

Unlike the JAX package, which reads the variable once at import, the port
reads it when an engine is built (`serving_precision()`), so one process can
build engines at two precisions.

TF32 is switched off for matmuls and convolutions when this module is
imported: the 3x3 K^-1 back-projection needs full f32 (a 1e-3 relative error
on a pixel coordinate is about 2 cm), as the JAX package pins HIGHEST there.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_SPELLINGS = {'default': 'default', 'int8-a8': 'default', 'int8-xla': 'default',
              'float32': 'float32', 'f32': 'float32', 'fp32': 'float32',
              'highest': 'float32', 'int8': 'int8'}
_WITH_BF16_STORAGE = ('bf16', 'bfloat16', 'tensorfloat32')


def serving_precision():
    """The canonical precision named by MONOLOCO_TPU_PRECISION (default
    'default'); raises ValueError on a spelling the port does not serve."""
    raw = os.environ.get('MONOLOCO_TPU_PRECISION', 'default')
    if raw in _WITH_BF16_STORAGE:
        raise ValueError(
            f"MONOLOCO_TPU_PRECISION={raw!r} goes with bf16 weight storage, which the "
            f"torch port gains with serving (ROADMAP Queue 1 item 3)")
    if raw not in _SPELLINGS:
        raise ValueError(
            f"MONOLOCO_TPU_PRECISION={raw!r}: the torch port serves "
            f"{sorted(_SPELLINGS)}")
    return _SPELLINGS[raw]
