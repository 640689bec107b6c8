"""The fused folded-MLP kernels and their plain versions.

Counterpart of `monoloco_tpu/ops/fused_mlp.py`, whose five Pallas kernels
become three hand-written CUDA sources for Hopper:

- `csrc/wgmma_layer.cu` replaces K1 `_kernel` with bf16 weights
  (`fused_loco_forward` on a `pack_folded_weights` bf16 pack) and
  `_kernel_int8` act_mode 'none' (K5, w8a16, `fused_loco_forward_w8`): one
  launch for the input projection, one TMA + wgmma launch per H x H layer
  with the layer's epilogue fused, and one for the heads: 2S + 4 launches a
  call, and for K5 one more that widens the int8 stack to bf16 first. `input_projection_plain`, `layer_plain` and `heads_plain` are the
  plain versions of those launches, and `layered_forward_plain` chains them.
- `csrc/fused_mlp.cu` replaces K1 with f32 weights, one launch a call;
- `csrc/dyn8_mlp.cu` replaces `_kernel_int8` act_modes 'dynamic' and
  'static' and `_kernel_int8_resident`, as two modes of one kernel, one
  launch a call: 'dynamic' (K2/K3, `fused_loco_forward_dyn8` and its
  `_resident` and `_auto` names) and 'static' (K4,
  `fused_loco_forward_int8`, packed by `pack_folded_weights_int8` from a
  calibration batch). dyn8 and K5 take the calibration-free pack
  `pack_folded_weights_w8`: H x H layers as int8 with per-output-column
  scales, the input projection and heads as bf16.

A wrapper runs the kernel's plain PyTorch version for a tensor on the CPU,
and launches the kernel for a CUDA tensor, or raises; nothing falls back
from the kernel to the plain version. The plain versions follow the float
order of the Pallas kernels, except that their bf16 and int8 products sum in
float64, where the sums are exact: so their result does not depend on the
order of a sum, and a row never depends on the batch around it. `launches`
counts the calls that ran on a card, per kernel: one per forward call (which
for K1-bf16 and K5 makes 2S + 4 or 2S + 5 CUDA launches), and one per call of the
single-layer entry `loco_layer`, so a run can show that it went through the
kernels.

The JAX entries take `tile` (rows per grid step, 512 by default); the
wrappers accept it and ignore it, since the Hopper kernels fix their own
tiles and the tile never changes the result.
"""

import ctypes

import torch

from . import _build
from .quant import quant_weight, quantize_folded

# Kernel name -> launches on CUDA tensors in this process.
launches = {'dyn8_mlp': 0, 'int8_static_mlp': 0, 'w8_mlp': 0,
            'fused_mlp_bf16': 0, 'fused_mlp_f32': 0,
            'wgmma_layer_bf16': 0, 'wgmma_layer_w8': 0}

# The JAX package's VMEM budget for its resident flavour (int8: one byte per
# element). On Hopper both flavours are one kernel and the stack is read
# from L2 (50 MB), so the budget only keeps `dyn8_resident_eligible` true to
# its JAX meaning.
_RESIDENT_MAX_STACK_BYTES = 16 * 1024 * 1024

_TILE_ROWS = 16          # kTileRows in csrc/mlp_common.cuh
_MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90
_MAX_HEAD_OUTPUTS = 16    # kMaxOut in csrc/wgmma_layer.cu

# act_mode -> (mode of csrc/dyn8_mlp.cu, launches key)
_INT8W_MODES = {'dynamic': (0, 'dyn8_mlp'), 'static': (1, 'int8_static_mlp')}

# Epilogue of an H x H layer -> its code (mlp::Epilogue, csrc/mlp_common.cuh).
EPILOGUES = {'store': 0, 'relu': 1, 'add_relu': 2}


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


_INT8W_PLAIN = {'dynamic': dyn8_forward_plain, 'static': int8_static_forward_plain}


# --- the layered forward of K1-bf16 and K5, launch by launch ---------------

def input_projection_plain(x, w0, b0):
    """The input projection: y = relu(bf16(x) @ w0 + b0) in f32, and bf16(y)."""
    y = torch.relu(_bf16_matmul(x, w0) + b0[None, :])
    return y, y.to(torch.bfloat16)


def layer_plain(a, w, bias, epilogue, oscale=None, y=None):
    """One H x H layer: v = a @ w + bias, a (m, H) bf16 and w (H, H) bf16,
    or w int8 and v = (a @ w) * oscale + bias; f32 sums. Returns (m, H)
    bf16: bf16(v) for 'store', bf16(relu(v)) for 'relu'; for 'add_relu' it
    adds relu(v) to the f32 residual y in place and returns bf16(y)."""
    v = _bf16_matmul(a, w)
    if oscale is not None:
        v = v * oscale[None, :]
    v = v + bias[None, :]
    if epilogue == 'relu':
        v = torch.relu(v)
    elif epilogue == 'add_relu':
        v = y.add_(torch.relu(v))
    elif epilogue != 'store':
        raise ValueError(f"unknown epilogue {epilogue!r}: one of {sorted(EPILOGUES)}")
    return v.to(torch.bfloat16)


def heads_plain(y2, y3, waux, baux, wfin, bfin):
    """The heads on bf16 y2 and y3: [y3 @ wfin + bfin, y2 @ waux + baux]."""
    return torch.cat([_bf16_matmul(y3, wfin) + bfin[None, :],
                      _bf16_matmul(y2, waux) + baux[None, :]], dim=1)


def _layer_schedule(n_mm):
    """(layer, input buffer, output buffer, epilogue) per H x H layer; buffer
    0 holds bf16(y) after the input projection. y2 ends in buffer 1, y3 in 0."""
    out = []
    for i in range(0, n_mm - 2, 2):
        out += [(i, 0, 1, 'relu'), (i + 1, 1, 0, 'add_relu')]
    return out + [(n_mm - 2, 0, 1, 'store'), (n_mm - 1, 1, 0, 'relu')]


def _layered_args(packed):
    """(w0, b0, wstack, bstack, oscale or None, waux, baux, wfin, bfin) of a
    bf16 pack (`pack_folded_weights`) or a w8 pack (`pack_folded_weights_w8`)."""
    if len(packed) == 10:
        w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin = packed
        return w0, b0, wq, bstack, oscale, waux, baux, wfin, bfin
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    return w0, b0, wstack, bstack, None, waux, baux, wfin, bfin


def layered_forward_plain(packed, x):
    """The forward of K1-bf16 and K5 as their kernels launch it, one plain
    function per launch; bit for bit `fused_forward_plain` (bf16 pack) or
    `w8_forward_plain` (w8 pack)."""
    w0, b0, wstack, bstack, oscale, waux, baux, wfin, bfin = _layered_args(packed)
    y, first = input_projection_plain(x, w0, b0)
    bufs = [first, None]
    for i, src, dst, epilogue in _layer_schedule(wstack.shape[0]):
        bufs[dst] = layer_plain(bufs[src], wstack[i], bstack[i], epilogue,
                                None if oscale is None else oscale[i], y)
    return heads_plain(bufs[1], bufs[0], waux, baux, wfin, bfin)


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


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(key, lib, err):
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: "
                           f"{lib.mlp_error_string(err).decode()} ({err})")


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
        err = call(out, _stream(x.device))
    _raise_on(key, lib, err)
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
    return _launch(key, lib, x, out_dim, lib.int8w_mlp_smem_bytes(hidden, in_dim),
                   lambda out, stream: lib.int8w_mlp_forward(
                       mode, x.data_ptr(), w0.data_ptr(), b0.data_ptr(), wq.data_ptr(),
                       inv_in.data_ptr(), oscale.data_ptr(), bstack.data_ptr(),
                       waux.data_ptr(), baux.data_ptr(), wfin.data_ptr(), bfin.data_ptr(),
                       out.data_ptr(), m, in_dim, hidden, n_mm, out_dim, stream))


def _fused_f32_kernel(packed, x):
    """Launch csrc/fused_mlp.cu (f32 weights) on x's device."""
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    key = 'fused_mlp_f32'
    hidden, n_mm = w0.shape[1], wstack.shape[0]
    expect = _expect(x, torch.float32, w0, b0, bstack, waux, baux, wfin, bfin)
    expect['wstack'] = (wstack, torch.float32, (n_mm, hidden, hidden))
    _check_args(key, x, expect)
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"{key} kernel: needs 2 * stages + 2 layers, got {n_mm}")
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    lib = _build.load_library()
    return _launch(key, lib, x, out_dim, lib.fused_mlp_smem_bytes(hidden, in_dim),
                   lambda out, stream: lib.fused_mlp_forward(
                       x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                       wstack.data_ptr(), bstack.data_ptr(), waux.data_ptr(),
                       baux.data_ptr(), wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(),
                       m, in_dim, hidden, n_mm, out_dim, stream))


def _layer_call(lib, a, w, bias, epilogue, oscale, y, out, stream):
    """csrc/wgmma_layer.cu on one layer with bf16 weights; returns the C
    function's code."""
    return lib.wgmma_layer_forward(
        a.data_ptr(), w.data_ptr(), None if oscale is None else oscale.data_ptr(),
        bias.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(), a.shape[0],
        a.shape[1], EPILOGUES[epilogue], stream)


def _widen(key, lib, wq, stream):
    """The int8 weights `wq` as bf16 (exact), widened on the card."""
    wide = torch.empty(wq.shape, dtype=torch.bfloat16, device=wq.device)
    _raise_on(key, lib, lib.widen_int8_forward(wq.data_ptr(), wide.data_ptr(), wq.numel(),
                                               stream))
    return wide


def _layered_kernel(packed, x):
    """K1-bf16 or K5 on x's device, as csrc/wgmma_layer.cu launches: for K5
    the widening of the int8 stack, then the input projection, 2S + 2
    layers and the heads, on the current stream, each launch checked.
    Scratch: y (m, H) f32, two (m, H) bf16 buffers, and for K5 the bf16
    stack (n_mm, H, H)."""
    w0, b0, wstack, bstack, oscale, waux, baux, wfin, bfin = _layered_args(packed)
    w8 = oscale is not None
    key = 'w8_mlp' if w8 else 'fused_mlp_bf16'
    hidden, n_mm = w0.shape[1], wstack.shape[0]
    expect = _expect(x, torch.bfloat16, w0, b0, bstack, waux, baux, wfin, bfin)
    expect['wstack'] = (wstack, torch.int8 if w8 else torch.bfloat16, (n_mm, hidden, hidden))
    if w8:
        expect['oscale'] = (oscale, torch.float32, (n_mm, hidden))
    _check_args(key, x, expect)
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"{key} kernel: needs 2 * stages + 2 layers, got {n_mm}")
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    if out_dim > _MAX_HEAD_OUTPUTS:
        raise ValueError(f"{key} kernel: the heads take at most {_MAX_HEAD_OUTPUTS} outputs, "
                         f"got {out_dim}")
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    y = torch.empty((m, hidden), dtype=torch.float32, device=x.device)
    bufs = [torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device) for _ in range(2)]
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        if w8:
            wstack = _widen(key, lib, wstack, stream)
        _raise_on(key, lib, lib.loco_input_forward(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), y.data_ptr(), bufs[0].data_ptr(),
            m, in_dim, hidden, stream))
        for i, src, dst, epilogue in _layer_schedule(n_mm):
            _raise_on(key, lib, _layer_call(lib, bufs[src], wstack[i], bstack[i], epilogue,
                                            oscale[i] if w8 else None, y, bufs[dst], stream))
        _raise_on(key, lib, lib.loco_heads_forward(
            bufs[1].data_ptr(), bufs[0].data_ptr(), waux.data_ptr(), baux.data_ptr(),
            wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(), m, hidden, out_dim, stream))
    launches[key] += 1
    return out


def _fused_kernel(packed, x):
    """K1 on x's device, by its weight type."""
    wdtype = packed[2].dtype
    if wdtype == torch.bfloat16:
        return _layered_kernel(packed, x)
    if wdtype == torch.float32:
        return _fused_f32_kernel(packed, x)
    raise ValueError(f"fused_mlp kernel: weights must be bf16 or f32, got {wdtype}")


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
    `dtype` per call. Requires hidden % 128 == 0. On a card, f32 weights run
    csrc/fused_mlp.cu in one launch; bf16 weights run csrc/wgmma_layer.cu in
    2S + 4 launches. Either counts one call in `launches`."""
    del tile
    if packed is None:
        packed = pack_folded_weights(folded, dtype=dtype)
    return _route('fused forward', packed, x, fused_forward_plain, _fused_kernel)


def loco_layer(a, w, bias, epilogue, oscale=None, y=None):
    """One H x H layer of K1-bf16 (w bf16) or K5 (w int8 with oscale), as
    `layer_plain` computes it: a CPU tensor runs `layer_plain`, a CUDA
    tensor launches csrc/wgmma_layer.cu (for int8 weights, the widening and
    then the layer; counted once in launches['wgmma_layer_bf16' or
    'wgmma_layer_w8']). 'add_relu' updates the f32 residual y in place.
    Requires H % 128 == 0."""
    m, hidden = a.shape
    if hidden % 128 != 0:
        raise ValueError(f"layer kernel requires hidden % 128 == 0, got {hidden}")
    if epilogue == 'add_relu' and y is None:
        raise ValueError("the add_relu epilogue needs the residual y")
    if a.device.type == 'cpu':
        return layer_plain(a, w, bias, epilogue, oscale, y)
    if a.device.type != 'cuda':
        raise ValueError(f"layer: no path for a tensor on {a.device}")
    w8 = oscale is not None
    key = 'wgmma_layer_w8' if w8 else 'wgmma_layer_bf16'
    f32 = torch.float32
    expect = {'a': (a, torch.bfloat16, (m, hidden)),
              'w': (w, torch.int8 if w8 else torch.bfloat16, (hidden, hidden)),
              'bias': (bias, f32, (hidden,))}
    if w8:
        expect['oscale'] = (oscale, f32, (hidden,))
    if y is not None:
        expect['y'] = (y, f32, (m, hidden))
    _check_args(key, a, expect)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}: one of {sorted(EPILOGUES)}")
    out = torch.empty((m, hidden), dtype=torch.bfloat16, device=a.device)
    if m == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        if w8:
            w = _widen(key, lib, w, stream)
        _raise_on(key, lib, _layer_call(lib, a, w, bias, epilogue, oscale, y, out, stream))
    launches[key] += 1
    return out


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
    """Weight-only int8 (w8a16, K5) forward on (m, in) f32 inputs; packed
    from pack_folded_weights_w8. On a card: 2S + 5 launches of
    csrc/wgmma_layer.cu, counted as one call in launches['w8_mlp']."""
    del tile
    return _route('int8 forward (none)', packed, x, w8_forward_plain, _layered_kernel)
