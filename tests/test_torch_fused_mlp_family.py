"""The port's K1 (bf16/f32 fused MLP), K4 (static a8w8) and K5 (w8a16)
entries against the JAX package's Pallas kernels, which run here in
interpret mode, as tests/test_fused_mlp.py runs them.

Both frameworks pack the same folded weights (the JAX fold with perturbed BN,
as numpy; hidden 128, 3 stages) and take inputs from a numpy seed. Packing
is exact, except inv_in and out_scale of the static pack, which come from a
calibration replay summed in each framework's order (rtol 1e-6).

On the CPU the wrappers run the plain versions. K1 with f32 weights is held
to test_fused_mlp.py's atol 1e-5. The bf16 and int8 plain versions sum their
products exactly in float64 where the Pallas kernels sum in f32; a last-ulp
difference can flip one bf16 or int8 rounding of a later layer. So, on the
JAX package's own pack, the mean error is held to 1e-5 of the mean output
and the max to 1e-2, as for dyn8 (tests/test_torch_fused_mlp.py).

The CUDA kernels are held against the plain versions in
tests/test_torch_kernels_cuda.py, which needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoloco_tpu.models import fold_eval_params as jax_fold
from monoloco_tpu.models import folded_forward as jax_folded_forward
from monoloco_tpu.models import init_loco_params as jax_init
from monoloco_tpu.ops import fused_mlp as jf
from monoloco_tpu_torch import ops
from monoloco_tpu_torch.ops import fused_mlp as tf

F32_ATOL = 1e-5
MEAN_REL_TOL = 1e-5
MAX_ABS_TOL = 1e-2


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def _pack_to_torch(packed):
    """A JAX pack as torch tensors of the same dtypes (bf16 through f32,
    which holds every bf16 value exactly)."""
    out = []
    for a in packed:
        if a.dtype == jnp.bfloat16:
            out.append(torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return tuple(out)


def _fold(in_dim, out_dim, key=0, seed=0):
    params, bn = jax_init(jax.random.PRNGKey(key), in_dim, out_dim, 128, 3)
    rng = np.random.default_rng(seed)
    bn = jax.tree_util.tree_map(np.array, bn)
    for s in (bn['bn1'], bn['bn3'], bn['stages']['bn1'], bn['stages']['bn2']):
        s['mean'] = rng.normal(0, 0.1, s['mean'].shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, s['var'].shape).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax_fold(params, bn))


@pytest.fixture(scope='module')
def folded():
    return _fold(34, 9)


@pytest.fixture(scope='module')
def folded_stereo():
    return _fold(68, 10, key=3, seed=3)


def _inputs(m, in_dim=34, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(m, in_dim)) * scale).astype(np.float32)


@pytest.fixture(scope='module')
def calib():
    return _inputs(512, seed=9)


def _assert_close(ours, ref):
    diff = np.abs(ours - ref)
    assert diff.mean() <= MEAN_REL_TOL * np.abs(ref).mean(), diff.mean()
    assert diff.max() <= MAX_ABS_TOL, diff.max()


def _assert_pack_equal(jax_pack, torch_pack, rtol_at=()):
    assert len(jax_pack) == len(torch_pack)
    for i, (a, b) in enumerate(zip(_pack_to_torch(jax_pack), torch_pack)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if i in rtol_at:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, err_msg=f'packed[{i}]')
        else:
            np.testing.assert_array_equal(b.float().numpy(), a.float().numpy(),
                                          err_msg=f'packed[{i}]')


@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
def test_pack_folded_weights_matches_jax_exactly(folded, dtype):
    jdt, tdt = {'bf16': (jnp.bfloat16, torch.bfloat16),
                'f32': (jnp.float32, torch.float32)}[dtype]
    tp = tf.pack_folded_weights(_to_torch(folded), dtype=tdt)
    _assert_pack_equal(jf.pack_folded_weights(folded, dtype=jdt), tp)
    assert tp[2].dtype == tdt and tp[2].shape == (8, 128, 128)
    assert tp[1].dtype == tp[3].dtype == torch.float32


def test_pack_folded_weights_int8_matches_jax(folded, calib):
    """Exact but for inv_in (3) and out_scale (4), rtol 1e-6."""
    tp = tf.pack_folded_weights_int8(_to_torch(folded), torch.from_numpy(calib))
    _assert_pack_equal(jf.pack_folded_weights_int8(folded, jnp.asarray(calib)), tp,
                       rtol_at=(3, 4))
    assert tp[2].dtype == torch.int8 and tp[3].shape == (8,)


@pytest.mark.parametrize('m', [77, 256])
def test_k1_f32_matches_jax(folded, m):
    x = _inputs(m)
    ref = np.asarray(jf.fused_loco_forward(folded, jnp.asarray(x), dtype=jnp.float32,
                                           tile=128, interpret=True))
    ours = tf.fused_loco_forward(_to_torch(folded), torch.from_numpy(x),
                                 dtype=torch.float32).numpy()
    assert ours.shape == (m, 9)
    np.testing.assert_allclose(ours, ref, atol=F32_ATOL)
    np.testing.assert_allclose(ours, np.asarray(jax_folded_forward(folded, x)), atol=F32_ATOL)


def test_k1_f32_stereo_shape(folded_stereo):
    x = _inputs(64, in_dim=68, seed=4)
    ref = np.asarray(jf.fused_loco_forward(folded_stereo, jnp.asarray(x), dtype=jnp.float32,
                                           tile=64, interpret=True))
    ours = tf.fused_loco_forward(_to_torch(folded_stereo), torch.from_numpy(x),
                                 dtype=torch.float32).numpy()
    assert ours.shape == (64, 10)
    np.testing.assert_allclose(ours, ref, atol=F32_ATOL)


@pytest.mark.parametrize('m', [77, 256])
def test_k1_bf16_plain_matches_jax_on_its_pack(folded, m):
    jp = jf.pack_folded_weights(folded, dtype=jnp.bfloat16)
    x = _inputs(m)
    ref = np.asarray(jf.fused_loco_forward(None, jnp.asarray(x), packed=jp, tile=128,
                                           interpret=True))
    ours = tf.fused_loco_forward(None, torch.from_numpy(x), packed=_pack_to_torch(jp)).numpy()
    _assert_close(ours, ref)


@pytest.mark.parametrize('m', [77, 256])
def test_k4_plain_matches_jax_on_its_pack(folded, calib, m):
    jp = jf.pack_folded_weights_int8(folded, jnp.asarray(calib))
    x = calib[:m]
    ref = np.asarray(jf.fused_loco_forward_int8(jp, jnp.asarray(x), tile=128, interpret=True))
    ours = tf.fused_loco_forward_int8(_pack_to_torch(jp), torch.from_numpy(x)).numpy()
    _assert_close(ours, ref)
    # The port's own calibration gives the same result here.
    own = tf.pack_folded_weights_int8(_to_torch(folded), torch.from_numpy(calib))
    _assert_close(tf.fused_loco_forward_int8(own, torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize('m', [77, 256])
def test_k5_plain_matches_jax_on_its_pack(folded, m):
    jp = jf.pack_folded_weights_w8(folded)
    x = _inputs(m, seed=12)
    ref = np.asarray(jf.fused_loco_forward_w8(jp, jnp.asarray(x), tile=128, interpret=True))
    ours = tf.fused_loco_forward_w8(_pack_to_torch(jp), torch.from_numpy(x)).numpy()
    _assert_close(ours, ref)


@pytest.mark.parametrize('kernel', ['k4', 'k5'])
def test_int8_plain_versions_take_stereo_widths(folded_stereo, kernel):
    x = _inputs(77, in_dim=68, seed=6)
    if kernel == 'k4':
        jp = jf.pack_folded_weights_int8(folded_stereo, jnp.asarray(x))
        ref = jf.fused_loco_forward_int8(jp, jnp.asarray(x), tile=128, interpret=True)
        ours = tf.fused_loco_forward_int8(_pack_to_torch(jp), torch.from_numpy(x))
    else:
        jp = jf.pack_folded_weights_w8(folded_stereo)
        ref = jf.fused_loco_forward_w8(jp, jnp.asarray(x), tile=128, interpret=True)
        ours = tf.fused_loco_forward_w8(_pack_to_torch(jp), torch.from_numpy(x))
    assert ours.shape == (77, 10)
    _assert_close(ours.numpy(), np.asarray(ref))


def test_k4_accuracy_budget_against_f32(folded, calib):
    """The JAX package's budget on in-calibration data (test_fused_mlp.py:84)."""
    tp = tf.pack_folded_weights_int8(_to_torch(folded), torch.from_numpy(calib))
    x = calib[:256]
    ref = np.asarray(jax_folded_forward(folded, x))
    out = tf.fused_loco_forward_int8(tp, torch.from_numpy(x)).numpy()
    assert (np.abs(out - ref) / np.maximum(np.abs(ref), 0.5)).mean() < 0.05


def test_k5_accuracy_budget_against_f32(folded):
    """The JAX package's budget (test_fused_mlp.py:166)."""
    tp = tf.pack_folded_weights_w8(_to_torch(folded))
    x = _inputs(256, seed=12)
    ref = np.asarray(jax_folded_forward(folded, x))
    out = tf.fused_loco_forward_w8(tp, torch.from_numpy(x)).numpy()
    assert (np.abs(out - ref) / np.maximum(np.abs(ref), 0.5)).mean() < 0.005


def _entries(folded, calib):
    """entry name -> fn(x, **kw) over the port's packs."""
    tfold = _to_torch(folded)
    p_bf16 = tf.pack_folded_weights(tfold)
    p_f32 = tf.pack_folded_weights(tfold, dtype=torch.float32)
    p_w8 = tf.pack_folded_weights_w8(tfold)
    p_a8 = tf.pack_folded_weights_int8(tfold, torch.from_numpy(calib))
    return {
        'k1_bf16': lambda x, **kw: tf.fused_loco_forward(None, x, packed=p_bf16, **kw),
        'k1_f32': lambda x, **kw: tf.fused_loco_forward(None, x, packed=p_f32, **kw),
        'k4': lambda x, **kw: tf.fused_loco_forward_int8(p_a8, x, **kw),
        'k5': lambda x, **kw: tf.fused_loco_forward_w8(p_w8, x, **kw),
        'dyn8': lambda x, **kw: tf.fused_loco_forward_dyn8(p_w8, x, **kw),
        'dyn8_resident': lambda x, **kw: tf.fused_loco_forward_dyn8_resident(p_w8, x, **kw),
        'dyn8_auto': lambda x, **kw: tf.fused_loco_forward_dyn8_auto(p_w8, x, **kw),
    }


def test_every_entry_takes_the_jax_tile_keyword(folded, calib):
    """bench.py:97 and tools/bench_pallas_int8.py:63-70 pass tile=; the
    Hopper kernels fix their own tiles, so tile never changes a result."""
    x = torch.from_numpy(_inputs(40, seed=4))
    for name, fn in _entries(folded, calib).items():
        base = fn(x)
        for tile in (128, 512):
            assert torch.equal(fn(x, tile=tile), base), (name, tile)


def test_plain_versions_rows_are_independent_bit_for_bit(folded, calib):
    big = torch.from_numpy(_inputs(512, seed=7))
    for name, fn in _entries(folded, calib).items():
        out_big = fn(big)
        for m in (1, 8, 77):
            assert torch.equal(fn(big[:m]), out_big[:m]), (name, m)


def test_cpu_tensors_never_count_a_launch(folded, calib):
    before = dict(ops.launches)
    for fn in _entries(folded, calib).values():
        fn(torch.from_numpy(_inputs(16)))
    assert ops.launches == before
    assert set(before) == {'dyn8_mlp', 'int8_static_mlp', 'w8_mlp',
                           'fused_mlp_bf16', 'fused_mlp_f32',
                           'wgmma_layer_bf16', 'wgmma_layer_w8',
                           'wgmma_layer_f32', 'wgmma_layer_dyn8', 'wgmma_layer_static',
                           'relu_chain_bf16'}


def test_entries_reject_unaligned_hidden_and_other_devices(folded, calib):
    params, bn = jax_init(jax.random.PRNGKey(5), 34, 9, 96, 2)
    narrow = _to_torch(jax.tree_util.tree_map(np.asarray, jax_fold(params, bn)))
    x = torch.zeros(8, 34)
    with pytest.raises(ValueError, match='hidden % 128'):
        tf.fused_loco_forward(narrow, x)
    for pack, fn in ((tf.pack_folded_weights_w8(narrow), tf.fused_loco_forward_w8),
                     (tf.pack_folded_weights_int8(narrow, x), tf.fused_loco_forward_int8)):
        with pytest.raises(ValueError, match='hidden % 128'):
            fn(pack, x)
    for name, fn in _entries(folded, calib).items():
        with pytest.raises(ValueError, match='no path'):
            fn(torch.zeros(8, 34, device='meta'))
