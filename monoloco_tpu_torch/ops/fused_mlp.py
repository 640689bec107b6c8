"""The fused folded-MLP kernels and their plain versions.

Counterpart of `monoloco_tpu/ops/fused_mlp.py`, whose five Pallas kernels
become two hand-written CUDA sources for Hopper:

- `csrc/fused_mlp.cu` replaces K1 `_kernel` (`fused_loco_forward`, weights
  packed by `pack_folded_weights` in bf16 or f32), with the weight type as a
  template parameter;
- `csrc/dyn8_mlp.cu` replaces `_kernel_int8` in its three act_modes and
  `_kernel_int8_resident`, as three modes of one kernel: 'dynamic' (K2/K3,
  `fused_loco_forward_dyn8` and its `_resident` and `_auto` names), 'static'
  (K4, `fused_loco_forward_int8`, packed by `pack_folded_weights_int8` from a
  calibration batch) and 'none' (K5, `fused_loco_forward_w8`). The dynamic
  and none modes take the calibration-free pack `pack_folded_weights_w8`:
  H x H layers as int8 with per-output-column scales, the input projection
  and heads as bf16.

A wrapper runs the kernel's plain PyTorch version for a tensor on the CPU,
and launches the kernel for a CUDA tensor, or raises; nothing falls back
from the kernel to the plain version. The plain versions follow the float
order of the Pallas kernels, except that their bf16 and int8 products sum in
float64, where the sums are exact: so their result does not depend on the
order of a sum, and a row never depends on the batch around it. `launches`
counts kernel launches per kernel, so a run can show that it went through
the kernels.

The JAX entries take `tile` (rows per grid step, 512 by default); the
wrappers accept it and ignore it, since each Hopper kernel's tile is 16 rows
and the tile never changes the result.
"""

import ctypes

import torch

from . import _build
from .quant import quant_weight, quantize_folded

# Kernel name -> launches on CUDA tensors in this process.
launches = {'dyn8_mlp': 0, 'int8_static_mlp': 0, 'w8_mlp': 0,
            'fused_mlp_bf16': 0, 'fused_mlp_f32': 0}

# The JAX package's VMEM budget for its resident flavour (int8: one byte per
# element). On Hopper both flavours are one kernel and the stack is read
# from L2 (50 MB), so the budget only keeps `dyn8_resident_eligible` true to
# its JAX meaning.
_RESIDENT_MAX_STACK_BYTES = 16 * 1024 * 1024

_TILE_ROWS = 16          # kTileRows in csrc/mlp_common.cuh
_MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90

# act_mode -> (mode of csrc/dyn8_mlp.cu, launches key)
_INT8W_MODES = {'dynamic': (0, 'dyn8_mlp'), 'static': (1, 'int8_static_mlp'),
                'none': (2, 'w8_mlp')}


def _layers(folded):
    """The H x H layers as (w, b) in the kernels' order [s0a, s0b, s1a, s1b,
    ..., w2, w3f]."""
    st_a, st_b = folded['stages']['a'], folded['stages']['b']
    out = []
    for i in range(st_a['w'].shape[0]):
        out += [(st_a['w'][i], st_a['b'][i]), (st_b['w'][i], st_b['b'][i])]
    return out + [(folded['w2']['w'], folded['w2']['b']),
                  (folded['w3f']['w'], folded['w3f']['b'])]


def pack_folded_weights(folded, dtype=torch.bfloat16):
    """Pack the folded Loco weights for the K1 kernel, on the folded tensors'
    device: (w0, b0, w_stack (2S+2, H, H), b_stack (2S+2, H), w_aux, b_aux,
    w_fin, b_fin), weights in `dtype` (bf16 or f32), biases f32."""
    ws, bs = zip(*_layers(folded))
    f32 = torch.float32
    return (
        folded['l0']['w'].to(dtype).contiguous(),
        folded['l0']['b'].to(f32).contiguous(),
        torch.stack(ws).to(dtype).contiguous(),
        torch.stack(bs).to(f32).contiguous(),
        folded['w_aux']['w'].to(dtype).contiguous(),
        folded['w_aux']['b'].to(f32).contiguous(),
        folded['w_fin']['w'].to(dtype).contiguous(),
        folded['w_fin']['b'].to(f32).contiguous(),
    )


def _int8_pack(folded, wqs, inv_in, oscales, bs):
    f32 = torch.float32
    return (
        folded['l0']['w'].to(torch.bfloat16).contiguous(),
        folded['l0']['b'].to(f32).contiguous(),
        torch.stack(wqs).contiguous(),
        inv_in.to(f32).contiguous(),
        torch.stack(oscales).to(f32).contiguous(),
        torch.stack(bs).to(f32).contiguous(),
        folded['w_aux']['w'].to(torch.bfloat16).contiguous(),
        folded['w_aux']['b'].to(f32).contiguous(),
        folded['w_fin']['w'].to(torch.bfloat16).contiguous(),
        folded['w_fin']['b'].to(f32).contiguous(),
    )


def pack_folded_weights_w8(folded):
    """Pack for the dyn8 and w8a16 modes (no calibration). Returns (w0 bf16,
    b0, wq (n_mm, H, H) int8, inv_in (n_mm,) ones — unused, kept for the JAX
    tuple layout —, oscale (n_mm, H), bstack (n_mm, H), waux bf16, baux, wfin
    bf16, bfin)."""
    layers = _layers(folded)
    wqs, oscales = zip(*(quant_weight(w) for w, _ in layers))
    ones = torch.ones(len(layers), dtype=torch.float32, device=folded['l0']['w'].device)
    return _int8_pack(folded, wqs, ones, oscales, [b for _, b in layers])


def pack_folded_weights_int8(folded, calib_x):
    """Pack for the static a8w8 mode, calibrated on `calib_x` by
    `quantize_folded`: the tuple of `pack_folded_weights_w8` with inv_in =
    1 / (per-layer activation scale) and oscale = activation scale x weight
    column scale."""
    q = quantize_folded(folded, calib_x)
    wqs, in_scales, out_scales, bs = [], [], [], []
    for i in range(q['stages']['a']['wq'].shape[0]):
        for half, s_in in (('a', q['stages']['a_in'][i]), ('b', q['stages']['b_in'][i])):
            st = q['stages'][half]
            wqs.append(st['wq'][i])
            in_scales.append(s_in)
            out_scales.append(s_in * st['scale'][i])
            bs.append(st['b'][i])
    for name, s_in in (('w2', q['y_out']), ('w3f', q['y2_in'])):
        wqs.append(q[name]['wq'])
        in_scales.append(s_in)
        out_scales.append(s_in * q[name]['scale'])
        bs.append(q[name]['b'])
    s = torch.stack(in_scales).float()
    return _int8_pack(folded, wqs, torch.ones_like(s) / s, out_scales, bs)


def dyn8_resident_eligible(packed):
    """Whether the int8 stack fits the JAX package's resident budget."""
    return packed[2].numel() <= _RESIDENT_MAX_STACK_BYTES


# --- plain versions ---------------------------------------------------------

def _bf16_matmul(act, w):
    """bf16(act) x w -> f32, w's values exact in bf16 (bf16 or int8): the
    products are exact in f32 and their sum is exact in float64, then
    rounded once to f32."""
    return (act.to(torch.bfloat16).double() @ w.double()).float()


def _f64_matmul(act, w):
    """f32 x f32 -> f32 through float64: each product is exact and the sum
    is within float64 rounding of exact, so the result hardly depends on the
    order of the sum."""
    return (act.double() @ w.double()).float()


def _chain(x, mm, layer, n_mm, w0, b0, waux, baux, wfin, bfin):
    """The folded forward: `mm(a, w)` the input projection and head
    products, `layer(a, i)` the i-th H x H layer with its bias."""
    y = torch.relu(mm(x, w0) + b0[None, :])
    for i in range(0, n_mm - 2, 2):
        h = torch.relu(layer(y, i))
        h = torch.relu(layer(h, i + 1))
        y = y + h
    y2 = layer(y, n_mm - 2)
    aux = mm(y2, waux) + baux[None, :]
    y3 = torch.relu(layer(y2, n_mm - 1))
    fin = mm(y3, wfin) + bfin[None, :]
    return torch.cat([fin, aux], dim=1)


def fused_forward_plain(packed, x):
    """Plain PyTorch K1 forward (`_kernel`, `monoloco_tpu/ops/fused_mlp.py:63`):
    (m, in) f32 -> (m, out) f32, [fin, aux]. With bf16 weights every
    product's activation is rounded to bf16 first; with f32 weights the
    products are f32."""
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    mm = _bf16_matmul if wstack.dtype == torch.bfloat16 else _f64_matmul
    return _chain(x, mm, lambda a, i: mm(a, wstack[i]) + bstack[i][None, :],
                  wstack.shape[0], w0, b0, waux, baux, wfin, bfin)


def _dynamic_layer(act, wq, oscale, bias):
    """One dyn8 H x H layer, in the float order of `_int8_mm` 'dynamic'
    (`monoloco_tpu/ops/fused_mlp.py:344-356`)."""
    amax = act.abs().amax(dim=1, keepdim=True)
    safe = torch.clamp(amax, min=1e-8)
    s = safe * (1.0 / 127.0)
    inv = torch.full_like(safe, 127.0) / safe
    q = torch.clamp(torch.round(act * inv), -127, 127)
    acc = (q.double() @ wq.double()).float()
    return acc * (s * oscale[None, :]) + bias[None, :]


def _static_layer(act, wq, inv_in, oscale, bias):
    """One static a8w8 H x H layer, in the float order of `_int8_mm`
    'static' (`:335-343`): no row scale."""
    q = torch.clamp(torch.round(act * inv_in), -127, 127)
    acc = (q.double() @ wq.double()).float()
    return acc * oscale[None, :] + bias[None, :]


def dyn8_forward_plain(packed, x):
    """Plain PyTorch dyn8 forward (K2/K3): (m, in) f32 -> (m, out) f32."""
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    return _chain(x, _bf16_matmul, lambda a, i: _dynamic_layer(a, wq[i], oscale[i], bstack[i]),
                  wq.shape[0], w0, b0, waux, baux, wfin, bfin)


def int8_static_forward_plain(packed, x):
    """Plain PyTorch static a8w8 forward (K4): (m, in) f32 -> (m, out) f32."""
    (w0, b0, wq, inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    return _chain(x, _bf16_matmul,
                  lambda a, i: _static_layer(a, wq[i], inv_in[i], oscale[i], bstack[i]),
                  wq.shape[0], w0, b0, waux, baux, wfin, bfin)


def w8_forward_plain(packed, x):
    """Plain PyTorch w8a16 forward (K5, `_int8_mm` 'none', `:357-364`):
    bf16 activations times the int8 weights (exact in bf16), f32 sums, the
    column scale on the output."""
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    return _chain(x, _bf16_matmul,
                  lambda a, i: _bf16_matmul(a, wq[i]) * oscale[i][None, :] + bstack[i][None, :],
                  wq.shape[0], w0, b0, waux, baux, wfin, bfin)


_INT8W_PLAIN = {'dynamic': dyn8_forward_plain, 'static': int8_static_forward_plain,
                'none': w8_forward_plain}


# --- kernels ----------------------------------------------------------------

def _check_args(kernel, x, expect):
    """Raise unless every tensor is on x's device with the dtype and shape
    the kernel takes, contiguous and 16-byte aligned."""
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel} kernel: {name} has dtype {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel} kernel: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} must be contiguous and 16-byte aligned")


def _expect(x, wdtype, w0, b0, bstack, waux, baux, wfin, bfin):
    """The shapes and dtypes both kernels take for x, the input projection,
    the biases of the H x H layers and the heads."""
    hidden = w0.shape[1]
    f32 = torch.float32
    return {
        'x': (x, f32, (x.shape[0], w0.shape[0])),
        'w0': (w0, wdtype, (x.shape[1], hidden)),
        'b0': (b0, f32, (hidden,)),
        'bstack': (bstack, f32, (bstack.shape[0], hidden)),
        'waux': (waux, wdtype, (hidden, 1)),
        'baux': (baux, f32, (1,)),
        'wfin': (wfin, wdtype, (hidden, wfin.shape[1])),
        'bfin': (bfin, f32, (wfin.shape[1],)),
    }


def _launch(key, lib, x, out_dim, smem, call):
    """Check the tile's shared memory, allocate the output, run
    `call(out, stream)` on x's device and PyTorch's current stream, and count
    the launch."""
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{key} kernel: this hidden width needs {smem} bytes of shared "
                         f"memory for a {_TILE_ROWS}-row tile; sm_90 allows "
                         f"{_MAX_SMEM_BYTES}")
    m = x.shape[0]
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = call(out, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: "
                           f"{lib.mlp_error_string(err).decode()} ({err})")
    if m:
        launches[key] += 1
    return out


def _int8w_kernel(packed, x, act_mode):
    """Launch csrc/dyn8_mlp.cu in `act_mode` on x's device."""
    (w0, b0, wq, inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    mode, key = _INT8W_MODES[act_mode]
    hidden, n_mm = w0.shape[1], wq.shape[0]
    expect = _expect(x, torch.bfloat16, w0, b0, bstack, waux, baux, wfin, bfin)
    expect.update(wq=(wq, torch.int8, (n_mm, hidden, hidden)),
                  inv_in=(inv_in, torch.float32, (n_mm,)),
                  oscale=(oscale, torch.float32, (n_mm, hidden)))
    _check_args(key, x, expect)
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"{key} kernel: needs 2 * stages + 2 int8 layers, got {n_mm}")
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    lib = _build.load_library()
    return _launch(key, lib, x, out_dim, lib.int8w_mlp_smem_bytes(mode, hidden, in_dim),
                   lambda out, stream: lib.int8w_mlp_forward(
                       mode, x.data_ptr(), w0.data_ptr(), b0.data_ptr(), wq.data_ptr(),
                       inv_in.data_ptr(), oscale.data_ptr(), bstack.data_ptr(),
                       waux.data_ptr(), baux.data_ptr(), wfin.data_ptr(), bfin.data_ptr(),
                       out.data_ptr(), m, in_dim, hidden, n_mm, out_dim, stream))


def _fused_kernel(packed, x):
    """Launch csrc/fused_mlp.cu (bf16 or f32 weights) on x's device."""
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    wdtype = wstack.dtype
    if wdtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mlp kernel: weights must be bf16 or f32, got {wdtype}")
    key = 'fused_mlp_bf16' if wdtype == torch.bfloat16 else 'fused_mlp_f32'
    hidden, n_mm = w0.shape[1], wstack.shape[0]
    expect = _expect(x, wdtype, w0, b0, bstack, waux, baux, wfin, bfin)
    expect['wstack'] = (wstack, wdtype, (n_mm, hidden, hidden))
    _check_args(key, x, expect)
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"{key} kernel: needs 2 * stages + 2 layers, got {n_mm}")
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    is_bf16 = int(wdtype == torch.bfloat16)
    lib = _build.load_library()
    return _launch(key, lib, x, out_dim, lib.fused_mlp_smem_bytes(is_bf16, hidden, in_dim),
                   lambda out, stream: lib.fused_mlp_forward(
                       is_bf16, x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                       wstack.data_ptr(), bstack.data_ptr(), waux.data_ptr(),
                       baux.data_ptr(), wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(),
                       m, in_dim, hidden, n_mm, out_dim, stream))


def _route(name, packed, x, plain, kernel):
    """A CPU tensor runs `plain`, a CUDA tensor launches `kernel`."""
    hidden = packed[0].shape[1]
    if hidden % 128 != 0:
        raise ValueError(f"fused kernel requires hidden % 128 == 0, got {hidden}")
    if x.device.type == 'cpu':
        return plain(packed, x)
    if x.device.type == 'cuda':
        return kernel(packed, x)
    raise ValueError(f"{name}: no path for a tensor on {x.device}")


# --- entry points (the JAX package's names) ---------------------------------

def fused_loco_forward(folded, x, dtype=torch.bfloat16, tile=512, packed=None):
    """K1 fused forward on (m, in) f32 inputs: returns (m, out) f32. Pass a
    pre-packed tuple (`pack_folded_weights`) to skip packing `folded` in
    `dtype` per call. Requires hidden % 128 == 0."""
    del tile
    if packed is None:
        packed = pack_folded_weights(folded, dtype=dtype)
    return _route('fused forward', packed, x, fused_forward_plain, _fused_kernel)


def _int8w_forward(packed, x, act_mode):
    return _route(f'int8 forward ({act_mode})', packed, x, _INT8W_PLAIN[act_mode],
                  lambda p, v: _int8w_kernel(p, v, act_mode))


def fused_loco_forward_dyn8(packed, x, tile=512):
    """Dynamic-int8 fused forward on (m, in) f32 inputs; packed from
    pack_folded_weights_w8. Returns (m, out) f32. Requires hidden % 128 == 0.

    The three JAX entry names — this one (streaming), `_resident` and `_auto`
    — are one function here: on Hopper one kernel serves both residencies
    (see csrc/dyn8_mlp.cu), so the JAX package's choice between them has
    nothing to pick.
    """
    del tile
    return _int8w_forward(packed, x, 'dynamic')


fused_loco_forward_dyn8_resident = fused_loco_forward_dyn8
fused_loco_forward_dyn8_auto = fused_loco_forward_dyn8


def fused_loco_forward_int8(packed, x, tile=512):
    """Static a8w8 fused forward (K4) on (m, in) f32 inputs; packed from
    pack_folded_weights_int8. A measured ablation: static calibration is not
    parity-grade on trained checkpoints (the JAX module's note)."""
    del tile
    return _int8w_forward(packed, x, 'static')


def fused_loco_forward_w8(packed, x, tile=512):
    """Weight-only int8 (w8a16, K5) fused forward on (m, in) f32 inputs;
    packed from pack_folded_weights_w8."""
    del tile
    return _int8w_forward(packed, x, 'none')
