"""Readings behind the port-vs-JAX rules that are derived from f32 sum
orders (tests/test_torch_layer_kernels.py `_sum_order_bound`,
tests/test_torch_generate_kitti.py `_xyz_close`, tests/test_torch_parallel.py
`_assert_step_close`), on this CPU:

1. K1-bf16 at hidden 128/256, 34 -> 9 and 68 -> 10: whether a jnp replica
   of the Pallas `_kernel` body equals its interpret output; per dot, the
   share of outputs where XLA:CPU's f32 sum differs from the exact one and
   the mean gap; the plain chain against the interpret output, as a share
   of the mean output and of the derived bound, and the share of bf16
   roundings that can flip under it.
2. The byte-compat MonoLoco++ on the mono joints fixture: each side's net
   outputs and decoded x, y, z against float64, and port against JAX as a
   share of (1 + d).
3. A dp2 step against one device (gloo, 2 ranks), pre-BN gradients live:
   the largest weight gap after the step and its entry's two gradients.

Run from the root of the repo:  python tests/torch_sum_order_probe.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def chain_readings():
    from monoloco_tpu_torch.ops import fused_mlp as tf
    from test_torch_layer_kernels import (_fold, _inputs, _jax_entry, _jax_pack, _pack_to_torch,
                                          _sum_order_bound)

    def dot(a, w):
        return jax.lax.dot_general(a.astype(jnp.bfloat16), w, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    for hidden, in_dim, out_dim in [(128, 34, 9), (128, 68, 10), (256, 34, 9), (256, 68, 10)]:
        jp = _jax_pack(_fold(hidden, in_dim, out_dim), 'bf16')
        w0, b0, ws, bs, waux, baux, wfin, bfin = jp
        x = _inputs(256, in_dim, seed=hidden + 3)
        ref = np.asarray(_jax_entry(jp, 'bf16')(jnp.asarray(x)))

        @jax.jit
        def replica(x):
            dots = [(x, w0)]
            y = jnp.maximum(dot(x, w0) + b0[None], 0.)
            for i in range(0, ws.shape[0] - 2, 2):
                dots.append((y, ws[i]))
                h = jnp.maximum(dot(y, ws[i]) + bs[i][None], 0.)
                dots.append((h, ws[i + 1]))
                y = y + jnp.maximum(dot(h, ws[i + 1]) + bs[i + 1][None], 0.)
            y2 = dot(y, ws[-2]) + bs[-2][None]
            y3 = jnp.maximum(dot(y2, ws[-1]) + bs[-1][None], 0.)
            dots += [(y, ws[-2]), (y2, ws[-1]), (y2, waux), (y3, wfin)]
            out = jnp.concatenate([dot(y3, wfin) + bfin[None], dot(y2, waux) + baux[None]], 1)
            return out, [(a, w, dot(a, w)) for a, w in dots]

        out, dots = replica(jnp.asarray(x))
        differ, gap = [], []
        for a, w, d in dots:
            a64 = np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32), np.float64)
            exact = (a64 @ np.asarray(w.astype(jnp.float32), np.float64)).astype(np.float32)
            differ.append(float(np.mean(np.asarray(d) != exact)))
            gap.append(float(np.abs(np.asarray(d) - exact).mean() / np.abs(exact).mean()))
        packed = _pack_to_torch(jp)
        xt = torch.from_numpy(x)
        chain = tf.layered_forward_plain(packed, xt).numpy()
        bound, flip_share = _sum_order_bound(packed, xt, with_share=True)
        print(json.dumps({
            'probe': 'k1_bf16_chain', 'hidden': hidden, 'in_dim': in_dim,
            'replica_equals_interpret': bool(np.array_equal(np.asarray(out), ref)),
            'dot_outputs_differing_from_exact': [min(differ), max(differ)],
            'dot_mean_gap_of_mean': [min(gap), max(gap)],
            'chain_vs_kernel_mean_of_mean_output': {
                m: float(np.abs(chain[:m] - ref[:m]).mean() / np.abs(ref[:m]).mean())
                for m in (1, 77, 256)},
            'bound_mean_of_mean_output': float(bound.mean() / np.abs(ref).mean()),
            'chain_vs_kernel_of_bound': float(np.abs(chain - ref).mean() / bound.mean()),
            'roundings_that_can_flip': flip_share}))


def decode_readings():
    from monoloco_tpu.models import fold_eval_params as jax_fold
    from monoloco_tpu.models import folded_forward as jax_forward
    from monoloco_tpu.models import load_checkpoint as jax_load
    from monoloco_tpu.network.decode import extract_outputs as jax_decode
    from monoloco_tpu_torch.models import fold_eval_params, folded_forward, load_checkpoint
    from monoloco_tpu_torch.network.decode import extract_outputs

    model = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')
    with open(os.path.join(HERE, 'fixture_joints-kitti-mono.json')) as f:
        joints = json.load(f)
    x = np.asarray(joints['val']['X'] + joints['train']['X'], np.float32)
    params, bn, _ = jax_load(model)
    out_jax = np.asarray(jax_forward(jax_fold(params, bn), jnp.asarray(x)))
    tp, tbn, _ = load_checkpoint(model)
    out_port = folded_forward(fold_eval_params(tp, tbn), torch.from_numpy(x)).numpy()

    def f64(tree):
        return {k: f64(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.double()
    out64 = folded_forward(fold_eval_params(f64(tp), f64(tbn)),
                           torch.from_numpy(x).double()).numpy()
    theta, psi, r = out64[:, 0], out64[:, 1], out64[:, 2]
    x64, y64 = r * np.sin(psi) * np.cos(theta), r * np.cos(psi)
    xyz64 = np.stack([x64, y64, np.sqrt(np.maximum(r ** 2 - x64 ** 2 - y64 ** 2, 0))], 1)
    xyz_jax = np.asarray(jax_decode(jnp.asarray(out_jax))['xyzd'])[:, :3]
    xyz_port = extract_outputs(torch.from_numpy(out_port))['xyzd'][:, :3].numpy()
    # both decodes on the port's outputs, against float64 on the same outputs
    o64 = out_port.astype(np.float64)
    on_equal = {'jax': np.asarray(jax_decode(jnp.asarray(out_port))['xyzd'])[:, :2],
                'port': xyz_port[:, :2]}
    x_eq = o64[:, 2] * np.sin(o64[:, 1]) * np.cos(o64[:, 0])
    xy_eq = np.stack([x_eq, o64[:, 2] * np.cos(o64[:, 1])], 1)
    print(json.dumps({
        'probe': 'decode', 'rows': len(x),
        'net_outputs_mean_gap_to_f64': {'jax': float(np.abs(out_jax - out64).mean()),
                                        'port': float(np.abs(out_port - out64).mean())},
        'xyz_mean_gap_to_f64': {'jax': np.abs(xyz_jax - xyz64).mean(0).tolist(),
                                'port': np.abs(xyz_port - xyz64).mean(0).tolist()},
        'xy_decode_max_gap_to_f64_on_equal_outputs': {
            k: float(np.abs(v - xy_eq).max()) for k, v in on_equal.items()},
        'xy_decodes_bit_equal_on_equal_outputs': bool(np.array_equal(on_equal['jax'],
                                                                     on_equal['port'])),
        'port_vs_jax_max_of_1_plus_d': float(
            (np.abs(xyz_port - xyz_jax).max(1) / (1 + np.abs(r))).max())}))


def dp_step_readings():
    from test_torch_parallel import _dp2_step
    root = tempfile.mkdtemp()
    try:
        joints = os.path.join(root, 'mono.json')
        shutil.copy(os.path.join(HERE, 'fixture_joints-kitti-mono.json'), joints)
        single, dp = _dp2_step(joints)
    finally:
        shutil.rmtree(root)
    worst = max(single['params'], key=lambda p: np.abs(dp['params'][p] - single['params'][p])
                .max() if p[-1] == 'w' else 0)
    gaps = np.abs(dp['params'][worst] - single['params'][worst])
    i = np.unravel_index(gaps.argmax(), gaps.shape)
    print(json.dumps({
        'probe': 'dp2_step', 'weight': '.'.join(worst), 'gap': float(gaps[i]),
        'gradients': [float(single['grads'][worst][i]), float(dp['grads'][worst][i])],
        'gradient_gap_of_norm': float(abs(single['grads'][worst][i] - dp['grads'][worst][i])
                                      / single['gnorm'])}))


if __name__ == '__main__':
    chain_readings()
    decode_readings()
    dp_step_readings()
