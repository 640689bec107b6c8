"""The fused folded-MLP kernels and their plain versions.

Counterpart of `monoloco_tpu/ops/fused_mlp.py`, whose five Pallas kernels
become two hand-written CUDA sources for Hopper:

- `csrc/wgmma_layer.cu` replaces K1 `_kernel` with bf16 weights
  (`fused_loco_forward` on a `pack_folded_weights` bf16 pack) and
  `_kernel_int8` act_mode 'none' (K5, w8a16, `fused_loco_forward_w8`): one
  launch for the input projection, one TMA + wgmma launch per H x H layer
  with the layer's epilogue fused, and one for the heads: 2S + 4 launches a
  call, and for K5 one more that widens the int8 stack to bf16 first.
  `input_projection_plain`, `layer_plain` and `heads_plain` are the plain
  versions of those launches, and `layered_forward_plain` chains them.
- `csrc/wgmma_layer_kmajor.cu` (with the input projection and heads of
  `wgmma_layer.cu`) replaces K1 with f32 weights (`fused_loco_forward` on an
  f32 pack), `_kernel_int8` act_mode 'dynamic' with `_kernel_int8_resident`
  (K2/K3, dyn8: `fused_loco_forward_dyn8` and its `_resident` and `_auto`
  names) and `_kernel_int8` act_mode 'static' (K4, `fused_loco_forward_int8`,
  packed by `pack_folded_weights_int8` from a calibration batch) in the same
  layered design, with operands wgmma reads K-major: K1-f32 as 3xTF32 layers
  on the tf32 parts of the activations and of the transposed stack (2S + 5
  launches a call), dyn8 as a row quantization and an s8 layer per H x H
  layer (4S + 7 launches), K4 as an s8 layer per H x H layer whose epilogue
  writes the next layer's int8 input with its calibrated scale (2S + 5
  launches). `split_tf32_plain`, `transpose_split_plain`, `f32_layer_plain`,
  `transpose_int8_plain`, `quantize_rows_plain`, `s8_layer_plain`,
  `static_input_plain` and `static_s8_layer_plain` are their plain
  launches; `layered_f32_forward_plain`, `layered_dyn8_forward_plain` and
  `layered_static_forward_plain` chain them.
dyn8 and K5 take the calibration-free pack `pack_folded_weights_w8`: H x H
layers as int8 with per-output-column scales, the input projection and heads
as bf16.

One more Pallas kernel lives outside the JAX package: the `kernel` of
`tools/bench_roofline.py` `bench_chain_resident` (K6, the `pl.pallas_call`
of `run_tile`), eight dependent bf16 layers y <- bf16(relu(y @ W_i)) with f32
sums and no bias, a probe of the chip's ceiling. `relu_chain` runs it as
eight launches of `csrc/relu_chain.cu`, a layer kernel of its own (B shared
across a 2-block cluster by TMA multicast, one wgmma group in flight, TMA
stores not waited on); `relu_chain_plain` chains `layer_plain`.

A wrapper runs the kernel's plain PyTorch version for a tensor on the CPU,
and launches the kernel for a CUDA tensor, or raises; nothing falls back
from the kernel to the plain version. The plain versions follow the float
order of the Pallas kernels, except that their bf16, int8 and f32 products
sum in float64, where the sums are exact or nearly so: so their result does
not depend on the order of a sum, and a row never depends on the batch
around it. `launches` counts the calls that ran on a card, per kernel: one
per forward call, whatever number of CUDA launches it makes, and one per
call of a single-layer entry (`loco_layer`, `loco_layer_f32`,
`loco_layer_dyn8`, `loco_layer_static`), so a run can show that it went
through the kernels.

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
            'wgmma_layer_bf16': 0, 'wgmma_layer_w8': 0,
            'wgmma_layer_f32': 0, 'wgmma_layer_dyn8': 0, 'wgmma_layer_static': 0,
            'relu_chain_bf16': 0}

# The JAX package's VMEM budget for its resident flavour (int8: one byte per
# element). On Hopper both flavours are one kernel and the stack is read
# from L2 (50 MB), so the budget only keeps `dyn8_resident_eligible` true to
# its JAX meaning.
_RESIDENT_MAX_STACK_BYTES = 16 * 1024 * 1024

_MAX_HEAD_OUTPUTS = 16    # kMaxOut in csrc/wgmma_layer.cu

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


def quantize_static_plain(act, inv):
    """K4's quantization of f32 act with a calibrated per-tensor inv (one
    f32 value), in the float order of `_int8_mm` 'static' (`:338`): q =
    clip(rint(act * inv), +-127) as int8, rint half to even."""
    return torch.clamp(torch.round(act * inv), -127, 127).to(torch.int8)


def _static_layer(act, wq, inv_in, oscale, bias):
    """One static a8w8 H x H layer, in the float order of `_int8_mm`
    'static' (`:335-343`): no row scale."""
    q = quantize_static_plain(act, inv_in)
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
    return _epilogue(v + bias[None, :], epilogue, y).to(torch.bfloat16)


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


def relu_chain_plain(x, ws):
    """K6's chain on x (m, H) bf16: y <- bf16(relu(y @ W_i + 0)) for each
    (H, H) bf16 W_i of ws, one `layer_plain` per layer (f32 sums, here
    exact). Returns (m, H) bf16."""
    zero = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    y = x
    for w in ws:
        y = layer_plain(y, w, zero, 'relu')
    return y


# --- the layered forwards of K1-f32 and dyn8, launch by launch -------------

def _tf32_round(t):
    """f32 t rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as f32 with the 13 low bits zero: adding half the dropped
    range to the magnitude bits carries into the kept ones (the float's
    sign is a separate bit). mlp::tf32_round in csrc/mlp_common.cuh."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_plain(t):
    """The 3xTF32 parts of f32 t: big = tf32(t), small = tf32(t - big); t -
    big is exact in f32, and big + small is within 2^-22 |t| of t."""
    big = _tf32_round(t)
    return big, _tf32_round(t - big)


def transpose_split_plain(wstack):
    """The tf32 parts of the transposed f32 stack (n, H_in, H_out) ->
    (n, H_out, H_in) each: the K-major operand of the 3xTF32 layers."""
    return split_tf32_plain(wstack.transpose(-1, -2).contiguous())


def f32_layer_plain(a, w, bias, epilogue, y=None):
    """One H x H layer of K1-f32: v = a @ w + bias, a (m, H) and w (H, H)
    f32, the sum rounded to f32 before the bias. Returns (m, H) f32: v for
    'store', relu(v) for 'relu'; 'add_relu' adds relu(v) to the residual y
    in place and returns y. The kernel reads a and w as their tf32 parts;
    the plain layer takes the f32 values they stand for, with products
    through float64."""
    return _epilogue(_f64_matmul(a, w) + bias[None, :], epilogue, y)


def _epilogue(v, epilogue, y):
    if epilogue == 'relu':
        return torch.relu(v)
    if epilogue == 'add_relu':
        return y.add_(torch.relu(v))
    if epilogue != 'store':
        raise ValueError(f"unknown epilogue {epilogue!r}: one of {sorted(EPILOGUES)}")
    return v


def layered_f32_forward_plain(packed, x):
    """The forward of K1-f32 as its kernels launch it (input projection,
    2S + 2 layers, heads), one plain function per launch; bit for bit
    `fused_forward_plain` on the f32 pack."""
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    y = torch.relu(_f64_matmul(x, w0) + b0[None, :])
    n_mm = wstack.shape[0]
    for i in range(0, n_mm - 2, 2):
        h = f32_layer_plain(y, wstack[i], bstack[i], 'relu')
        f32_layer_plain(h, wstack[i + 1], bstack[i + 1], 'add_relu', y)
    y2 = f32_layer_plain(y, wstack[n_mm - 2], bstack[n_mm - 2], 'store')
    y3 = f32_layer_plain(y2, wstack[n_mm - 1], bstack[n_mm - 1], 'relu')
    return torch.cat([_f64_matmul(y3, wfin) + bfin[None, :],
                      _f64_matmul(y2, waux) + baux[None, :]], dim=1)


def transpose_int8_plain(wq):
    """The int8 stack (n, H_in, H_out) transposed to (n, H_out, H_in): the
    K-major operand of the s8 layers."""
    return wq.transpose(-1, -2).contiguous()


def quantize_rows_plain(act):
    """dyn8's row quantization of f32 act (m, H), in the float order of
    `_int8_mm` 'dynamic': q (m, H) int8 and the row scales s (m,) f32."""
    amax = act.abs().amax(dim=1, keepdim=True)
    safe = torch.clamp(amax, min=1e-8)
    inv = torch.full_like(safe, 127.0) / safe
    q = torch.clamp(torch.round(act * inv), -127, 127).to(torch.int8)
    return q, (safe * (1.0 / 127.0))[:, 0]


def s8_layer_plain(q, s_row, wt, oscale, bias, epilogue, y=None):
    """One dyn8 H x H layer on quantized rows: v = f32(q @ wt^T) * (s_row
    * oscale) + bias, wt the transposed int8 weights (H_out, H_in); the
    epilogue as `f32_layer_plain`. Returns (f32 result, its bf16 rounding);
    for 'add_relu' the f32 result is y, updated in place."""
    acc = (q.double() @ wt.double().T).float()
    out = _epilogue(acc * (s_row[:, None] * oscale[None, :]) + bias[None, :], epilogue, y)
    return out, out.to(torch.bfloat16)


def layered_dyn8_forward_plain(packed, x):
    """The forward of dyn8 as its kernels launch it (the transposed stack,
    the input projection, a row quantization and an s8 layer per H x H
    layer, the heads), one plain function per launch; bit for bit
    `dyn8_forward_plain`."""
    (w0, b0, wq, _inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    wt = transpose_int8_plain(wq)
    y, _ = input_projection_plain(x, w0, b0)

    def layer(act, i, epilogue, res=None):
        return s8_layer_plain(*quantize_rows_plain(act), wt[i], oscale[i], bstack[i],
                              epilogue, res)

    n_mm = wq.shape[0]
    for i in range(0, n_mm - 2, 2):
        h, _ = layer(y, i, 'relu')
        layer(h, i + 1, 'add_relu', y)
    y2, y2_bf = layer(y, n_mm - 2, 'store')
    _, y3_bf = layer(y2, n_mm - 1, 'relu')
    return heads_plain(y2_bf, y3_bf, waux, baux, wfin, bfin)


# --- the layered forward of K4, launch by launch ---------------------------

def static_input_plain(x, w0, b0, inv0):
    """K4's input projection: y = relu(bf16(x) @ w0 + b0) in f32, and q0 =
    `quantize_static_plain(y, inv0)`, the first layer's int8 input."""
    y, _ = input_projection_plain(x, w0, b0)
    return y, quantize_static_plain(y, inv0)


def static_s8_layer_plain(q, wt, oscale, bias, epilogue, inv_next=None, y=None):
    """One static a8w8 (K4) H x H layer on its int8 input q: v = f32(q @
    wt^T) * oscale + bias, wt the transposed int8 weights (H_out, H_in); the
    epilogue as `f32_layer_plain`. Returns (f32 result, its bf16 rounding,
    q_next), q_next = `quantize_static_plain(result, inv_next)`, the next
    layer's int8 input, or None without inv_next; for 'add_relu' the f32
    result is y, updated in place."""
    acc = (q.double() @ wt.double().T).float()
    out = _epilogue(acc * oscale[None, :] + bias[None, :], epilogue, y)
    q_next = None if inv_next is None else quantize_static_plain(out, inv_next)
    return out, out.to(torch.bfloat16), q_next


def layered_static_forward_plain(packed, x):
    """The forward of K4 as its kernels launch it (the transposed stack, the
    input projection with the first quantization, one s8 layer per H x H
    layer, each quantizing its result for the next, the heads), one plain
    function per launch; bit for bit `int8_static_forward_plain`."""
    (w0, b0, wq, inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    wt = transpose_int8_plain(wq)
    n_mm = wq.shape[0]
    y, q = static_input_plain(x, w0, b0, inv_in[0])

    def layer(q, i, epilogue, res=None):
        inv_next = inv_in[i + 1] if i + 1 < n_mm else None
        return static_s8_layer_plain(q, wt[i], oscale[i], bstack[i], epilogue, inv_next, res)

    for i in range(0, n_mm - 2, 2):
        _, _, q = layer(q, i, 'relu')
        _, _, q = layer(q, i + 1, 'add_relu', y)
    _, y2_bf, q = layer(q, n_mm - 2, 'store')
    _, y3_bf, _ = layer(q, n_mm - 1, 'relu')
    return heads_plain(y2_bf, y3_bf, waux, baux, wfin, bfin)


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
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    _check_layered(key, x, expect, n_mm, out_dim)
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_layered(key, x, expect, n_mm, out_dim):
    """_check_args, and the layer count and head width the layered forwards
    take."""
    _check_args(key, x, expect)
    if n_mm < 2 or n_mm % 2:
        raise ValueError(f"{key} kernel: needs 2 * stages + 2 layers, got {n_mm}")
    if out_dim > _MAX_HEAD_OUTPUTS:
        raise ValueError(f"{key} kernel: the heads take at most {_MAX_HEAD_OUTPUTS} outputs, "
                         f"got {out_dim}")


def _tf32x3_call(lib, a, wt, bias, epilogue, out, parts, stream):
    """csrc/wgmma_layer_kmajor.cu on one 3xTF32 layer: a and wt are tf32
    part pairs, out (f32) and parts (a pair) the outputs, each possibly
    None; returns the C function's code."""
    big, small = parts if parts is not None else (None, None)
    return lib.tf32x3_layer_forward(
        a[0].data_ptr(), a[1].data_ptr(), wt[0].data_ptr(), wt[1].data_ptr(), bias.data_ptr(),
        _ptr(out), _ptr(big), _ptr(small), a[0].shape[0], a[0].shape[1], EPILOGUES[epilogue],
        stream)


def _transpose_split(key, lib, wstack, stream):
    """The tf32 parts of the transposed f32 stack, made on the card."""
    parts = [torch.empty(wstack.shape, dtype=torch.float32, device=wstack.device)
             for _ in range(2)]
    n = 1 if wstack.dim() == 2 else wstack.shape[0]
    _raise_on(key, lib, lib.transpose_split_tf32_forward(
        wstack.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), n, wstack.shape[-1], stream))
    return parts


def _layered_f32_kernel(packed, x):
    """K1-f32 on x's device, as csrc/wgmma_layer_kmajor.cu launches it: the
    tf32 parts of the transposed stack, the input projection (which also
    splits y), 2S + 2 3xTF32 layers and the heads, on the current stream,
    each launch checked. Scratch: y and two pairs of tf32 parts, (m, H) f32
    each, and the two parts of the stack (n_mm, H, H) f32."""
    w0, b0, wstack, bstack, waux, baux, wfin, bfin = packed
    key = 'fused_mlp_f32'
    hidden, n_mm = w0.shape[1], wstack.shape[0]
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    expect = _expect(x, torch.float32, w0, b0, bstack, waux, baux, wfin, bfin)
    expect['wstack'] = (wstack, torch.float32, (n_mm, hidden, hidden))
    _check_layered(key, x, expect, n_mm, out_dim)
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    y, *bufs = [torch.empty((m, hidden), dtype=torch.float32, device=x.device)
                for _ in range(5)]
    cur, nxt = bufs[:2], bufs[2:]
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        wt = _transpose_split(key, lib, wstack, stream)
        _raise_on(key, lib, lib.loco_input_f32_forward(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), y.data_ptr(), cur[0].data_ptr(),
            cur[1].data_ptr(), m, in_dim, hidden, stream))

        def layer(i, epilogue, res, parts):
            _raise_on(key, lib, _tf32x3_call(lib, cur, (wt[0][i], wt[1][i]), bstack[i],
                                             epilogue, res, parts, stream))

        for i in range(0, n_mm - 2, 2):
            layer(i, 'relu', None, nxt)
            cur, nxt = nxt, cur
            layer(i + 1, 'add_relu', y, nxt)
            cur, nxt = nxt, cur
        layer(n_mm - 2, 'store', y, nxt)          # y2 -> y (f32) and its parts
        cur, nxt = nxt, cur
        y3 = nxt[0]                               # free since the store read it
        layer(n_mm - 1, 'relu', y3, None)
        _raise_on(key, lib, lib.loco_heads_f32_forward(
            y.data_ptr(), y3.data_ptr(), waux.data_ptr(), baux.data_ptr(), wfin.data_ptr(),
            bfin.data_ptr(), out.data_ptr(), m, hidden, out_dim, stream))
    launches[key] += 1
    return out


def _dyn8_layer_calls(key, lib, act, q, s_row, wt, oscale, bias, epilogue, out, out_bf,
                      stream):
    """One dyn8 layer on the card: the row quantization of f32 act into q and
    s_row, then the s8 layer with its epilogue; each launch checked."""
    m, hidden = act.shape
    _raise_on(key, lib, lib.quantize_rows_forward(act.data_ptr(), q.data_ptr(),
                                                  s_row.data_ptr(), m, hidden, stream))
    _raise_on(key, lib, lib.s8_layer_forward(
        q.data_ptr(), s_row.data_ptr(), wt.data_ptr(), oscale.data_ptr(), bias.data_ptr(),
        _ptr(out), _ptr(out_bf), m, hidden, EPILOGUES[epilogue], stream))


def _transpose_int8(key, lib, wq, stream):
    """The transposed int8 stack, made on the card."""
    wt = torch.empty(wq.shape, dtype=torch.int8, device=wq.device)
    n = 1 if wq.dim() == 2 else wq.shape[0]
    _raise_on(key, lib, lib.transpose_int8_forward(wq.data_ptr(), wt.data_ptr(), n,
                                                   wq.shape[-1], stream))
    return wt


def _layered_dyn8_kernel(packed, x):
    """dyn8 on x's device, as csrc/wgmma_layer_kmajor.cu launches it: the
    transposed int8 stack, the input projection (wgmma_layer.cu), a row
    quantization and an s8 layer per H x H layer, and the heads, on the
    current stream, each launch checked. Scratch: y and h (m, H) f32, q (m,
    H) int8, the row scales, two (m, H) bf16 buffers for the heads and the
    transposed stack (n_mm, H, H) int8."""
    (w0, b0, wq, inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    key = 'dyn8_mlp'
    hidden, n_mm = w0.shape[1], wq.shape[0]
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    expect = _expect(x, torch.bfloat16, w0, b0, bstack, waux, baux, wfin, bfin)
    expect.update(wq=(wq, torch.int8, (n_mm, hidden, hidden)),
                  oscale=(oscale, torch.float32, (n_mm, hidden)))
    _check_layered(key, x, expect, n_mm, out_dim)
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    y, h = (torch.empty((m, hidden), dtype=torch.float32, device=x.device) for _ in range(2))
    q = torch.empty((m, hidden), dtype=torch.int8, device=x.device)
    s_row = torch.empty((m,), dtype=torch.float32, device=x.device)
    y2_bf, y3_bf = (torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
                    for _ in range(2))
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        wt = _transpose_int8(key, lib, wq, stream)
        _raise_on(key, lib, lib.loco_input_forward(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), y.data_ptr(), y2_bf.data_ptr(),
            m, in_dim, hidden, stream))

        def layer(act, i, epilogue, res, res_bf=None):
            _dyn8_layer_calls(key, lib, act, q, s_row, wt[i], oscale[i], bstack[i], epilogue,
                              res, res_bf, stream)

        for i in range(0, n_mm - 2, 2):
            layer(y, i, 'relu', h)
            layer(h, i + 1, 'add_relu', y)
        layer(y, n_mm - 2, 'store', h, y2_bf)    # y2: f32 in h, bf16 for the aux head
        layer(h, n_mm - 1, 'relu', None, y3_bf)   # y3: bf16 for the fin head only
        _raise_on(key, lib, lib.loco_heads_forward(
            y2_bf.data_ptr(), y3_bf.data_ptr(), waux.data_ptr(), baux.data_ptr(),
            wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(), m, hidden, out_dim, stream))
    launches[key] += 1
    return out


def _s8_static_call(key, lib, q, wt, oscale, bias, epilogue, inv_next, out, out_bf, q_next,
                    stream):
    """One static s8 layer on the card (csrc/wgmma_layer_kmajor.cu), checked;
    inv_next is a one-value f32 tensor on the card, or None without q_next."""
    m, hidden = q.shape
    _raise_on(key, lib, lib.s8_static_layer_forward(
        q.data_ptr(), wt.data_ptr(), oscale.data_ptr(), bias.data_ptr(), _ptr(inv_next),
        _ptr(out), _ptr(out_bf), _ptr(q_next), m, hidden, EPILOGUES[epilogue], stream))


def _layered_static_kernel(packed, x):
    """K4 on x's device, as csrc/wgmma_layer_kmajor.cu launches it: the
    transposed int8 stack, the input projection (wgmma_layer.cu), which also
    writes the first layer's int8 input, 2S + 2 static s8 layers, each
    writing the next layer's int8 input with that layer's inv_in (read on
    the card), and the heads: 2S + 5 launches on the current stream, each
    checked. Layer i reads q[i % 2] and writes q[(i + 1) % 2]; beside it the
    'add_relu' layers update y, w2 writes bf16 y2 and w3f bf16 y3 for the
    heads. Scratch: y (m, H) f32, two (m, H) int8 and two (m, H) bf16
    buffers, and the transposed stack (n_mm, H, H) int8."""
    (w0, b0, wq, inv_in, oscale, bstack, waux, baux, wfin, bfin) = packed
    key = 'int8_static_mlp'
    hidden, n_mm = w0.shape[1], wq.shape[0]
    m, in_dim = x.shape
    out_dim = wfin.shape[1] + 1
    expect = _expect(x, torch.bfloat16, w0, b0, bstack, waux, baux, wfin, bfin)
    expect.update(wq=(wq, torch.int8, (n_mm, hidden, hidden)),
                  inv_in=(inv_in, torch.float32, (n_mm,)),
                  oscale=(oscale, torch.float32, (n_mm, hidden)))
    _check_layered(key, x, expect, n_mm, out_dim)
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    y = torch.empty((m, hidden), dtype=torch.float32, device=x.device)
    qs = [torch.empty((m, hidden), dtype=torch.int8, device=x.device) for _ in range(2)]
    y2_bf, y3_bf = (torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
                    for _ in range(2))
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        wt = _transpose_int8(key, lib, wq, stream)
        _raise_on(key, lib, lib.loco_input_int8_forward(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), y.data_ptr(), qs[0].data_ptr(),
            inv_in.data_ptr(), m, in_dim, hidden, stream))

        def layer(i, epilogue, res=None, res_bf=None):
            last = i + 1 == n_mm
            _s8_static_call(key, lib, qs[i % 2], wt[i], oscale[i], bstack[i], epilogue,
                            None if last else inv_in[i + 1], res, res_bf,
                            None if last else qs[(i + 1) % 2], stream)

        for i in range(0, n_mm - 2, 2):
            layer(i, 'relu')                       # h: int8 only, for the b layer
            layer(i + 1, 'add_relu', y)             # y in place, and its int8 form
        layer(n_mm - 2, 'store', None, y2_bf)    # y2: bf16 for the aux head, int8 for w3f
        layer(n_mm - 1, 'relu', None, y3_bf)     # y3: bf16 for the fin head only
        _raise_on(key, lib, lib.loco_heads_forward(
            y2_bf.data_ptr(), y3_bf.data_ptr(), waux.data_ptr(), baux.data_ptr(),
            wfin.data_ptr(), bfin.data_ptr(), out.data_ptr(), m, hidden, out_dim, stream))
    launches[key] += 1
    return out


def _fused_kernel(packed, x):
    """K1 on x's device, by its weight type."""
    wdtype = packed[2].dtype
    if wdtype == torch.bfloat16:
        return _layered_kernel(packed, x)
    if wdtype == torch.float32:
        return _layered_f32_kernel(packed, x)
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
    `dtype` per call. Requires hidden % 128 == 0. On a card, bf16 weights
    run csrc/wgmma_layer.cu in 2S + 4 launches, f32 weights
    csrc/wgmma_layer_kmajor.cu's 3xTF32 layers in 2S + 5. Either counts one
    call in `launches`."""
    del tile
    if packed is None:
        packed = pack_folded_weights(folded, dtype=dtype)
    return _route('fused forward', packed, x, fused_forward_plain, _fused_kernel)


def _layer_device(a, epilogue, y):
    """'cpu' or 'cuda' for a single-layer entry on a (m, H), or raise."""
    if a.shape[1] % 128 != 0:
        raise ValueError(f"layer kernel requires hidden % 128 == 0, got {a.shape[1]}")
    if epilogue == 'add_relu' and y is None:
        raise ValueError("the add_relu epilogue needs the residual y")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}: one of {sorted(EPILOGUES)}")
    if a.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"layer: no path for a tensor on {a.device}")
    return a.device.type


def _layer_expect(a, adtype, w, wdtype, bias, y, **more):
    m, hidden = a.shape
    f32 = torch.float32
    expect = {'a': (a, adtype, (m, hidden)), 'w': (w, wdtype, (hidden, hidden)),
              'bias': (bias, f32, (hidden,))}
    expect.update({k: (t, f32, (hidden,)) for k, t in more.items()})
    if y is not None:
        expect['y'] = (y, f32, (m, hidden))
    return expect


def loco_layer(a, w, bias, epilogue, oscale=None, y=None):
    """One H x H layer of K1-bf16 (w bf16) or K5 (w int8 with oscale), as
    `layer_plain` computes it: a CPU tensor runs `layer_plain`, a CUDA
    tensor launches csrc/wgmma_layer.cu (for int8 weights, the widening and
    then the layer; counted once in launches['wgmma_layer_bf16' or
    'wgmma_layer_w8']). 'add_relu' updates the f32 residual y in place.
    Requires H % 128 == 0."""
    if _layer_device(a, epilogue, y) == 'cpu':
        return layer_plain(a, w, bias, epilogue, oscale, y)
    w8 = oscale is not None
    key = 'wgmma_layer_w8' if w8 else 'wgmma_layer_bf16'
    more = {'oscale': oscale} if w8 else {}
    _check_args(key, a, _layer_expect(a, torch.bfloat16, w, torch.int8 if w8 else torch.bfloat16,
                                      bias, y, **more))
    out = torch.empty(a.shape, dtype=torch.bfloat16, device=a.device)
    if a.shape[0] == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        if w8:
            w = _widen(key, lib, w, stream)
        _raise_on(key, lib, _layer_call(lib, a, w, bias, epilogue, oscale, y, out, stream))
    launches[key] += 1
    return out


def _run_relu_chain(key, x, ws, layer_call, count=True):
    """Check a chain's operands on a card and run it: layer_call(lib, a, w,
    out, stream), one layer's C call, made once per W_i into two (m, H) bf16
    buffers in turn; counted once in launches[key] if `count` and anything
    was launched. Returns the last output."""
    m, hidden = x.shape
    if hidden % 128 != 0:
        raise ValueError(f"relu_chain kernel requires hidden % 128 == 0, got {hidden}")
    if len(ws) == 0:
        raise ValueError("relu_chain needs at least one layer")
    expect = {'x': (x, torch.bfloat16, (m, hidden))}
    expect.update({f'ws[{i}]': (w, torch.bfloat16, (hidden, hidden)) for i, w in enumerate(ws)})
    _check_args(key, x, expect)
    bufs = [torch.empty_like(x) for _ in range(min(len(ws), 2))]
    if m == 0:
        return bufs[0]
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        y = x
        for i, w in enumerate(ws):
            _raise_on(key, lib, layer_call(lib, y, w, bufs[i % 2], stream))
            y = bufs[i % 2]
    if count:
        launches[key] += 1
    return y


def relu_chain(x, ws):
    """K6, the roofline probe's resident chain (`tools/bench_roofline.py`
    `bench_chain_resident`): y <- bf16(relu(y @ W_i)) for each W_i of ws, x
    (m, H) bf16, each W_i (H, H) bf16 (a list or a stacked (L, H, H)
    tensor), f32 sums, no bias. Returns (m, H) bf16. A CPU tensor runs
    `relu_chain_plain`; a CUDA tensor launches csrc/relu_chain.cu once per
    W_i, counted once per call in launches['relu_chain_bf16']. Scratch: two
    (m, H) bf16 buffers, the output one of them. Requires H % 128 == 0.

    The kernel of its own: the Pallas kernel keeps a 512-row tile's
    activations and all eight weights (16 MB at H = 1024) in VMEM and runs
    every layer in one grid step. A block on the H100 has 227 KB of shared
    memory: a 128-row bf16 tile at H = 1024 is 256 KB already. So the chain
    crosses device memory between layers: x and each layer's output once
    (bf16, 256 MB each at 131072 x 1024). The work is bound by its
    products, 2.2 TFLOP at 131072 x 1024 x 8, 2.22 ms at the bf16 peak,
    against 0.55 GB of inputs, output and weights (0.17 ms at 3.35 TB/s).
    csrc/relu_chain.cu is a layer kernel for that bound alone: relu and a
    bf16 pack, no bias. It keeps one wgmma group in flight, shares each B
    tile across a 2-block cluster by TMA multicast (B read from L2 once per
    256 rows, not 128), and stages the output through shared memory for
    TMA stores that the next tile's products do not wait on; it sizes its
    persistent grid of clusters itself. It runs the same wgmma shape and k
    order as the bf16 layer of csrc/wgmma_layer.cu, which ran the chain
    before with a zero bias, and agrees with it bit for bit."""
    if x.device.type == 'cpu':
        return relu_chain_plain(x, ws)
    if x.device.type != 'cuda':
        raise ValueError(f"relu_chain: no path for a tensor on {x.device}")
    return _run_relu_chain('relu_chain_bf16', x, ws, lambda lib, a, w, out, stream:
                           lib.relu_chain_layer_forward(a.data_ptr(), w.data_ptr(),
                                                        out.data_ptr(), a.shape[0], a.shape[1],
                                                        stream))


def _relu_chain_wgmma_layer(x, ws):
    """K6 as it ran before csrc/relu_chain.cu: csrc/wgmma_layer.cu's bf16
    layer once per W_i with the 'relu' epilogue and a zero f32 bias,
    bf16(relu(acc + 0)). A comparison path for a card (counts no launch)."""
    zero = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    return _run_relu_chain('wgmma_layer_bf16', x, ws,
                           lambda lib, a, w, out, stream: _layer_call(
                               lib, a, w, zero, 'relu', None, None, out, stream),
                           count=False)


def loco_layer_f32(a, w, bias, epilogue, y=None):
    """One H x H layer of K1-f32, as `f32_layer_plain` computes it: a CPU
    tensor runs `f32_layer_plain` (f32 products through float64), a CUDA
    tensor launches csrc/wgmma_layer_kmajor.cu: the tf32 parts of a and of
    w's transpose, then the 3xTF32 layer; counted once in
    launches['wgmma_layer_f32']. Returns (m, H) f32; 'add_relu' updates the
    residual y in place and returns it. Requires H % 128 == 0."""
    if _layer_device(a, epilogue, y) == 'cpu':
        return f32_layer_plain(a, w, bias, epilogue, y)
    key = 'wgmma_layer_f32'
    _check_args(key, a, _layer_expect(a, torch.float32, w, torch.float32, bias, y))
    m, hidden = a.shape
    out = y if epilogue == 'add_relu' else torch.empty_like(a)
    if m == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        wt = _transpose_split(key, lib, w, stream)
        parts = [torch.empty_like(a) for _ in range(2)]
        _raise_on(key, lib, lib.split_tf32_forward(a.data_ptr(), parts[0].data_ptr(),
                                                   parts[1].data_ptr(), a.numel(), stream))
        _raise_on(key, lib, _tf32x3_call(lib, parts, wt, bias, epilogue, out, None, stream))
    launches[key] += 1
    return out


def loco_layer_dyn8(act, wq, oscale, bias, epilogue, y=None):
    """One dyn8 H x H layer, as `quantize_rows_plain` then `s8_layer_plain`
    compute it: a CPU tensor runs those, a CUDA tensor launches
    csrc/wgmma_layer_kmajor.cu: the transposed int8 weights, the row
    quantization of the f32 act and the s8 layer; counted once in
    launches['wgmma_layer_dyn8']. Returns ((m, H) f32, (m, H) bf16);
    'add_relu' updates the residual y in place and returns it as the f32
    result. Requires H % 128 == 0."""
    if _layer_device(act, epilogue, y) == 'cpu':
        q, s_row = quantize_rows_plain(act)
        return s8_layer_plain(q, s_row, transpose_int8_plain(wq), oscale, bias, epilogue, y)
    key = 'wgmma_layer_dyn8'
    _check_args(key, act, _layer_expect(act, torch.float32, wq, torch.int8, bias, y,
                                        oscale=oscale))
    m, hidden = act.shape
    out = y if epilogue == 'add_relu' else torch.empty_like(act)
    out_bf = torch.empty(act.shape, dtype=torch.bfloat16, device=act.device)
    if m == 0:
        return out, out_bf
    q = torch.empty(act.shape, dtype=torch.int8, device=act.device)
    s_row = torch.empty((m,), dtype=torch.float32, device=act.device)
    lib = _build.load_library()
    with torch.cuda.device(act.device):
        stream = _stream(act.device)
        wt = _transpose_int8(key, lib, wq, stream)
        _dyn8_layer_calls(key, lib, act, q, s_row, wt, oscale, bias, epilogue, out, out_bf,
                          stream)
    launches[key] += 1
    return out, out_bf


def loco_layer_static(q, wq, oscale, bias, epilogue, inv_next=None, y=None):
    """One static a8w8 (K4) H x H layer on its int8 input q, as
    `static_s8_layer_plain` computes it (with the weights transposed): a CPU
    tensor runs that, a CUDA tensor launches csrc/wgmma_layer_kmajor.cu, the
    transposed int8 weights and then the static s8 layer, counted once in
    launches['wgmma_layer_static']. inv_next is the next layer's inv_in, a
    one-value f32 tensor on q's device (read there), or None. Returns ((m, H)
    f32, (m, H) bf16, (m, H) int8 q_next or None); 'add_relu' updates the
    residual y in place and returns it as the f32 result. Requires H % 128
    == 0."""
    device = _layer_device(q, epilogue, y)
    key = 'wgmma_layer_static'
    _check_args(key, q, _layer_expect(q, torch.int8, wq, torch.int8, bias, y, oscale=oscale))
    if inv_next is not None and (inv_next.device != q.device or inv_next.dtype != torch.float32
                                 or inv_next.numel() != 1):
        raise ValueError(f"{key} kernel: inv_next must be one f32 value on {q.device}, got "
                         f"{inv_next.dtype} of shape {tuple(inv_next.shape)} on {inv_next.device}")
    if device == 'cpu':
        return static_s8_layer_plain(q, transpose_int8_plain(wq), oscale, bias, epilogue,
                                     inv_next, y)
    m, hidden = q.shape
    out = y if epilogue == 'add_relu' else torch.empty(q.shape, dtype=torch.float32,
                                                         device=q.device)
    out_bf = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    q_next = None if inv_next is None else torch.empty_like(q)
    if m == 0:
        return out, out_bf, q_next
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        wt = _transpose_int8(key, lib, wq, stream)
        _s8_static_call(key, lib, q, wt, oscale, bias, epilogue, inv_next, out, out_bf, q_next,
                        stream)
    launches[key] += 1
    return out, out_bf, q_next


def fused_loco_forward_dyn8(packed, x, tile=512):
    """Dynamic-int8 fused forward on (m, in) f32 inputs; packed from
    pack_folded_weights_w8. Returns (m, out) f32. Requires hidden % 128 == 0.
    On a card: csrc/wgmma_layer_kmajor.cu's row quantizations and s8 layers
    with wgmma_layer.cu's input projection and heads, 4S + 7 launches,
    counted as one call in launches['dyn8_mlp'].

    The three JAX entry names — this one (streaming), `_resident` and `_auto`
    — are one function here: on Hopper the stack (8 MB at hidden 1024) is
    read from L2 by every 128-row tile whatever its size, so the JAX
    package's choice between them has nothing to pick.
    """
    del tile
    return _route('int8 forward (dynamic)', packed, x, dyn8_forward_plain,
                  _layered_dyn8_kernel)


fused_loco_forward_dyn8_resident = fused_loco_forward_dyn8
fused_loco_forward_dyn8_auto = fused_loco_forward_dyn8


def fused_loco_forward_int8(packed, x, tile=512):
    """Static a8w8 fused forward (K4) on (m, in) f32 inputs; packed from
    pack_folded_weights_int8. A measured ablation: static calibration is not
    parity-grade on trained checkpoints (the JAX module's note). Requires
    hidden % 128 == 0. On a card: csrc/wgmma_layer_kmajor.cu's static s8
    layers with wgmma_layer.cu's input projection and heads, 2S + 5
    launches, counted as one call in launches['int8_static_mlp']."""
    del tile
    return _route('int8 forward (static)', packed, x, int8_static_forward_plain,
                  _layered_static_kernel)


def fused_loco_forward_w8(packed, x, tile=512):
    """Weight-only int8 (w8a16, K5) forward on (m, in) f32 inputs; packed
    from pack_folded_weights_w8. On a card: 2S + 5 launches of
    csrc/wgmma_layer.cu, counted as one call in launches['w8_mlp']."""
    del tile
    return _route('int8 forward (none)', packed, x, w8_forward_plain, _layered_kernel)
