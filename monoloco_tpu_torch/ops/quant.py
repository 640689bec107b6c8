"""Static int8 post-training quantization of the folded MLP (plain torch).

Counterpart of `monoloco_tpu/ops/quant.py`: per-output-column int8 weights
(scale = max|w| / 127) and per-tensor static activation scales calibrated by
replaying the f32 folded forward on a representative batch. `quantize_folded`
feeds both the `int8-xla` bench leg (`quantized_forward`, plain torch here as
it is XLA in the JAX package) and the static a8w8 kernel's pack
(`fused_mlp.pack_folded_weights_int8`). Neither is what the engine serves:
the static scales are an ablation (not parity-grade on trained checkpoints,
see the JAX module's note).

Float order follows the JAX package operation by operation, and divisions
are tensor by tensor: on CUDA, PyTorch turns a division by a Python scalar
into a multiply by its reciprocal, which rounds differently.
"""

import numpy as np
import torch

from ..utils import precision as _precision  # noqa: F401  (switches TF32 off)

_KITTI_KK = [[718.3351, 0., 600.3891], [0., 718.3351, 181.5122], [0., 0., 1.]]


def synthetic_calibration_inputs(in_dim, n=2048, seed=1, device='cpu'):
    """The shared synthetic calibration batch of the a8 ablations: uniform
    keypoints over a KITTI-sized image through K^-1 (the JAX package's
    `synthetic_calibration_inputs`, same numpy draws). Stereo (in_dim 68)
    pairs side = round(sqrt(n)) left poses with as many right poses, all
    against all: (side^2, 68)."""
    # network imports ops
    from ..network.preprocess import preprocess_monoloco, preprocess_monstereo
    rng = np.random.RandomState(seed)
    kk = torch.tensor(_KITTI_KK, dtype=torch.float32, device=device)

    def draw(rows):
        return torch.from_numpy((rng.rand(rows, 3, 17) * 300).astype(np.float32)).to(device)

    if in_dim == 68:
        side = max(2, int(round(n ** 0.5)))
        kps_l = draw(side)
        inputs, _ = preprocess_monstereo(kps_l, draw(side), kk)
        return inputs
    return preprocess_monoloco(draw(n), kk)


def _div(a, b):
    """a / b as a true division on every device (b broadcast to a tensor)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device).expand_as(a)


def quant_weight(w):
    """(in, out) f32 -> (int8 weight, per-column f32 scale): scale =
    max|w| / 127 per column (1 for an all-zero column), q = round half to
    even of w / scale, clipped to +-127 (`monoloco_tpu/ops/quant.py:66-71`)."""
    amax = w.abs().amax(dim=0)
    scale = _div(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(_div(w, scale[None, :])), -127, 127).to(torch.int8)
    return q, scale.float()


def _quant_act(x, scale):
    return torch.clamp(torch.round(_div(x, scale)), -127, 127).to(torch.int8)


def _int8_matmul(xq, wq):
    """s8 x s8 -> exact integer sums as f32. The products run as an f32
    matmul of the int8 values with TF32 off (utils/precision.py): every
    partial sum is an integer below 127^2 * K, which f32 holds exactly while
    127^2 * K < 2^24, i.e. K <= 1040. Wider layers sum in float64."""
    if xq.shape[1] * 127 * 127 < 2 ** 24:
        return xq.float() @ wq.float()
    return (xq.double() @ wq.double()).float()


def _int8_dense(x, x_scale, layer):
    """f32 x -> int8 matmul -> f32 (+bias), as `_int8_dense` (`:78`)."""
    acc = _int8_matmul(_quant_act(x, x_scale), layer['wq'])
    return acc * (x_scale * layer['scale'])[None, :] + layer['b']


def _qlayer(layer):
    wq, scale = quant_weight(layer['w'])
    return {'wq': wq, 'scale': scale, 'b': layer['b']}


def quantize_folded(folded, calib_x):
    """Folded f32 eval params + calibration batch -> int8 serving params.

    The calibration replays the f32 folded forward ('loco' arch) and records
    max|activation| / 127 (at least 1e-8) entering each matmul. The replay
    sums in torch's order, so the scales agree with the JAX package's to
    about 1e-7 relative, not bit for bit."""
    x = torch.as_tensor(calib_x, dtype=torch.float32, device=folded['l0']['w'].device)

    def amax(v):
        return torch.clamp(_div(v.abs().amax(), 127.0), min=1e-8)

    st_a, st_b = folded['stages']['a'], folded['stages']['b']
    q = {'l0': _qlayer(folded['l0']), 'a_in': amax(x)}
    y = torch.relu(x @ folded['l0']['w'] + folded['l0']['b'])
    sa, sh = [], []
    for i in range(st_a['w'].shape[0]):
        sa.append(amax(y))
        h = torch.relu(y @ st_a['w'][i] + st_a['b'][i])
        sh.append(amax(h))
        h = torch.relu(h @ st_b['w'][i] + st_b['b'][i])
        y = y + h

    def qstacked(stacked):
        wqs, scales = zip(*(quant_weight(w) for w in stacked['w']))
        return {'wq': torch.stack(wqs), 'scale': torch.stack(scales), 'b': stacked['b']}

    q['stages'] = {'a': qstacked(st_a), 'b': qstacked(st_b),
                   'a_in': torch.stack(sa), 'b_in': torch.stack(sh)}
    q['y_out'] = amax(y)
    for name in ('w2', 'w_aux', 'w3f', 'w_fin'):
        q[name] = _qlayer(folded[name])
    y2 = y @ folded['w2']['w'] + folded['w2']['b']
    q['y2_in'] = amax(y2)
    y3 = torch.relu(y2 @ folded['w3f']['w'] + folded['w3f']['b'])
    q['y3_in'] = amax(y3)
    return q


def quantized_forward(q, x):
    """Static-int8 forward ('loco' arch) on (m, in) f32 inputs; returns raw
    (m, out) f32 outputs, [fin, aux]. Every matmul, the input projection and
    the heads included, quantizes its input with the calibrated scale."""
    y = torch.relu(_int8_dense(x, q['a_in'], q['l0']))
    st = q['stages']
    for i in range(st['a']['wq'].shape[0]):
        layer_a = {k: st['a'][k][i] for k in ('wq', 'scale', 'b')}
        layer_b = {k: st['b'][k][i] for k in ('wq', 'scale', 'b')}
        h = torch.relu(_int8_dense(y, st['a_in'][i], layer_a))
        h = torch.relu(_int8_dense(h, st['b_in'][i], layer_b))
        y = y + h
    y2 = _int8_dense(y, q['y_out'], q['w2'])
    aux = _int8_dense(y2, q['y2_in'], q['w_aux'])
    y3 = torch.relu(_int8_dense(y2, q['y2_in'], q['w3f']))
    fin = _int8_dense(y3, q['y3_in'], q['w_fin'])
    return torch.cat([fin, aux], dim=1)
