"""The fused dynamic-int8 (dyn8) folded-MLP kernel and its plain version.

Counterpart of the dyn8 family of `monoloco_tpu/ops/fused_mlp.py`: the
Pallas kernels `_kernel_int8` (act_mode 'dynamic', weights streamed) and
`_kernel_int8_resident` (weights held in VMEM) become ONE hand-written CUDA
kernel for Hopper, `csrc/dyn8_mlp.cu`, behind all three JAX entry names.
Weights are packed once (`pack_folded_weights_w8`): the H x H layers as int8
with per-output-column scales; the input projection and heads as bf16.
Activations are quantized per row inside the kernel, with no calibration.

A wrapper runs the plain PyTorch version (`dyn8_forward_plain`) for a tensor
on the CPU, and launches the kernel for a CUDA tensor, or raises; nothing
falls back from the kernel to the plain version. `launches` counts kernel
launches, so a run can show that it went through the kernel.
"""

import ctypes

import torch

from . import _build

# Kernel name -> launches on CUDA tensors in this process.
launches = {'dyn8_mlp': 0}

# The JAX package's VMEM budget for its resident flavour (int8: one byte per
# element). On Hopper both flavours are one kernel and the stack is read
# from L2 (50 MB), so the budget only keeps `dyn8_resident_eligible` true to
# its JAX meaning.
_RESIDENT_MAX_STACK_BYTES = 16 * 1024 * 1024

_TILE_ROWS = 16          # kTileRows in csrc/dyn8_mlp.cu
_MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90


def quant_weight(w):
    """(in, out) f32 -> (int8 weight, per-column f32 scale): scale =
    max|w| / 127 per column (1 for an all-zero column), q = round half to
    even of w / scale, clipped to +-127 (`monoloco_tpu/ops/quant.py:66-71`).
    Divisions are tensor by tensor: CUDA turns a division by a Python scalar
    into a multiply by its reciprocal, which rounds differently."""
    amax = w.abs().amax(dim=0)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale.float()


def pack_folded_weights_w8(folded):
    """Pack the folded Loco weights for the dyn8 kernel, on the folded
    tensors' device. Returns (w0 bf16, b0, wq (n_mm, H, H) int8, inv_in
    (n_mm,) ones — unused, kept for the JAX tuple layout —, oscale (n_mm, H),
    bstack (n_mm, H), waux bf16, baux, wfin bf16, bfin), with the layers in
    the order [s0a, s0b, s1a, s1b, ..., w2, w3f]."""
    stages_a = folded['stages']['a']
    stages_b = folded['stages']['b']
    wqs, oscales, bs = [], [], []
    for i in range(stages_a['w'].shape[0]):
        for st in (stages_a, stages_b):
            wq, scale = quant_weight(st['w'][i])
            wqs.append(wq)
            oscales.append(scale)
            bs.append(st['b'][i])
    for name in ('w2', 'w3f'):
        wq, scale = quant_weight(folded[name]['w'])
        wqs.append(wq)
        oscales.append(scale)
        bs.append(folded[name]['b'])
    f32 = torch.float32
    return (
        folded['l0']['w'].to(torch.bfloat16).contiguous(),
        folded['l0']['b'].to(f32).contiguous(),
        torch.stack(wqs).contiguous(),
        torch.ones(len(wqs), dtype=f32, device=folded['l0']['w'].device),
        torch.stack(oscales).to(f32).contiguous(),
        torch.stack(bs).to(f32).contiguous(),
        folded['w_aux']['w'].to(torch.bfloat16).contiguous(),
        folded['w_aux']['b'].to(f32).contiguous(),
        folded['w_fin']['w'].to(torch.bfloat16).contiguous(),
        folded['w_fin']['b'].to(f32).contiguous(),
    )


def dyn8_resident_eligible(packed):
    """Whether the int8 stack fits the JAX package's resident budget."""
    return packed[2].numel() <= _RESIDENT_MAX_STACK_BYTES


def _bf16_matmul(act, w_bf16):
    """bf16 x bf16 -> f32: both operands rounded to bf16 and their products
    (exact in f32) summed in float64, where the sum is exact for these
    magnitudes, then rounded once to f32. So the result does not depend on
    the order of the sum, and a row never depends on the batch around it."""
    return (act.to(torch.bfloat16).double() @ w_bf16.double()).float()


def _int8_matmul(act, wq, oscale, bias):
    """One dyn8 H x H layer, in the float order of `_int8_mm`
    (`monoloco_tpu/ops/fused_mlp.py:347-356`). The s8 x s8 sums run in
    float64, where every partial sum is an exact integer."""
    amax = act.abs().amax(dim=1, keepdim=True)
    safe = torch.clamp(amax, min=1e-8)
    s = safe * (1.0 / 127.0)
    inv = torch.full_like(safe, 127.0) / safe
    q = torch.clamp(torch.round(act * inv), -127, 127)
    acc = (q.double() @ wq.double()).float()
    return acc * (s * oscale[None, :]) + bias[None, :]


def dyn8_forward_plain(packed, x):
    """Plain PyTorch dyn8 forward: (m, in) f32 -> (m, out) f32, [fin, aux]."""
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    y = torch.relu(_bf16_matmul(x, w0) + b0[None, :])
    n_mm = wq.shape[0]
    for i in range(0, n_mm - 2, 2):
        h = torch.relu(_int8_matmul(y, wq[i], oscale[i], bstack[i]))
        h = torch.relu(_int8_matmul(h, wq[i + 1], oscale[i + 1], bstack[i + 1]))
        y = y + h
    y2 = _int8_matmul(y, wq[n_mm - 2], oscale[n_mm - 2], bstack[n_mm - 2])
    aux = _bf16_matmul(y2, waux) + baux[None, :]
    y3 = torch.relu(_int8_matmul(y2, wq[n_mm - 1], oscale[n_mm - 1], bstack[n_mm - 1]))
    fin = _bf16_matmul(y3, wfin) + bfin[None, :]
    return torch.cat([fin, aux], dim=1)


def _check_cuda_args(packed, x):
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    hidden = w0.shape[1]
    expect = {
        'x': (x, torch.float32, (x.shape[0], w0.shape[0])),
        'w0': (w0, torch.bfloat16, (x.shape[1], hidden)),
        'b0': (b0, torch.float32, (hidden,)),
        'wq': (wq, torch.int8, (wq.shape[0], hidden, hidden)),
        'oscale': (oscale, torch.float32, (wq.shape[0], hidden)),
        'bstack': (bstack, torch.float32, (wq.shape[0], hidden)),
        'waux': (waux, torch.bfloat16, (hidden, 1)),
        'baux': (baux, torch.float32, (1,)),
        'wfin': (wfin, torch.bfloat16, (hidden, wfin.shape[1])),
        'bfin': (bfin, torch.float32, (wfin.shape[1],)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device:
            raise ValueError(f"dyn8 kernel: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"dyn8 kernel: {name} has dtype {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dyn8 kernel: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dyn8 kernel: {name} must be contiguous and 16-byte aligned")
    n_mm = wq.shape[0]
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"dyn8 kernel: needs 2 * stages + 2 int8 layers, got {n_mm}")


def _dyn8_kernel(packed, x):
    """Launch csrc/dyn8_mlp.cu on x's device and PyTorch's current stream."""
    _check_cuda_args(packed, x)
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    m, in_dim = x.shape
    hidden = w0.shape[1]
    out_dim = wfin.shape[1] + 1
    lib = _build.load_library()
    smem = lib.dyn8_mlp_smem_bytes(hidden, in_dim)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"dyn8 kernel: hidden {hidden} needs {smem} bytes of shared "
                         f"memory for a {_TILE_ROWS}-row tile; sm_90 allows "
                         f"{_MAX_SMEM_BYTES}")
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dyn8_mlp_forward(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), wq.data_ptr(),
            oscale.data_ptr(), bstack.data_ptr(), waux.data_ptr(), baux.data_ptr(),
            wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(),
            m, in_dim, hidden, wq.shape[0], out_dim, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dyn8 kernel launch failed: "
                           f"{lib.dyn8_mlp_error_string(err).decode()} ({err})")
    if m:
        launches['dyn8_mlp'] += 1
    return out


def fused_loco_forward_dyn8(packed, x):
    """Dynamic-int8 fused forward on (m, in) f32 inputs; packed from
    pack_folded_weights_w8. Returns (m, out) f32. Requires hidden % 128 == 0.

    The three JAX entry names — this one (streaming), `_resident` and `_auto`
    — are one function here: on Hopper one kernel serves both residencies
    (see csrc/dyn8_mlp.cu), so the JAX package's choice between them has
    nothing to pick. A CPU tensor runs dyn8_forward_plain; a CUDA tensor
    launches the kernel.
    """
    hidden = packed[0].shape[1]
    if hidden % 128 != 0:
        raise ValueError(f"fused kernel requires hidden % 128 == 0, got {hidden}")
    if x.device.type == 'cpu':
        return dyn8_forward_plain(packed, x)
    if x.device.type == 'cuda':
        return _dyn8_kernel(packed, x)
    raise ValueError(f"dyn8 forward: no path for a tensor on {x.device}")


fused_loco_forward_dyn8_resident = fused_loco_forward_dyn8
fused_loco_forward_dyn8_auto = fused_loco_forward_dyn8
