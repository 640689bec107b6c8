"""The torch port's model and checkpoint code against the JAX package.

Same numpy inputs through both: init from JAX, BN statistics perturbed with a
numpy seed so the fold is not the identity, hidden 128, 3 stages. Tolerances:
f32 forwards agree to 1e-5 absolute (the two frameworks sum in different
orders; PARITY.md measured 1.8e-7 for the folded forward); checkpoint loads
are exact (both read the same numpy arrays).
"""

import os

import jax
import numpy as np
import pytest
import torch

from monoloco_tpu.models import (fold_eval_params as jax_fold,
                                 folded_forward as jax_folded_forward,
                                 init_loco_params as jax_init,
                                 load_checkpoint as jax_load,
                                 loco_forward as jax_loco_forward)
from monoloco_tpu_torch.models import (FoldedLoco, fold_eval_params, folded_forward,
                                       init_loco_params, load_checkpoint, loco_forward,
                                       params_from_numpy, save_checkpoint)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, 'goldens', 'byte_compat')
ATOL = 1e-5


def jax_params(in_dim=34, out_dim=9, hidden=128, stages=3, seed=0):
    """JAX-initialized params as numpy, BN statistics and affine perturbed."""
    params, bn = jax_init(jax.random.PRNGKey(seed), in_dim, out_dim, hidden, stages)
    params = jax.tree_util.tree_map(np.array, params)
    bn = jax.tree_util.tree_map(np.array, bn)
    rng = np.random.default_rng(seed)

    def perturb(p, s):
        shape = s['mean'].shape
        s['mean'] = rng.normal(0, 0.1, shape).astype(np.float32)
        s['var'] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        p['scale'] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        p['bias'] = rng.normal(0, 0.05, shape).astype(np.float32)

    perturb(params['bn1'], bn['bn1'])
    perturb(params['bn3'], bn['bn3'])
    for k in ('bn1', 'bn2'):
        perturb(params['stages'][k], bn['stages'][k])
    return params, bn


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f'{prefix}{k}.'))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize('in_dim,out_dim', [(34, 9), (68, 10)])
def test_fold_and_folded_forward_match_jax(in_dim, out_dim):
    params, bn = jax_params(in_dim, out_dim)
    jf = jax_fold(params, bn)
    tf = fold_eval_params(*params_from_numpy(params, bn))
    jl, tl = _leaves(jf), _leaves(tf)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-6, atol=1e-7, err_msg=k)
    x = np.random.default_rng(1).normal(size=(77, in_dim)).astype(np.float32)
    ref = np.asarray(jax_folded_forward(jf, x))
    out = folded_forward(tf, torch.from_numpy(x)).numpy()
    assert out.shape == (77, out_dim)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_array_equal(FoldedLoco(tf)(torch.from_numpy(x)).numpy(), out)


def test_eval_forward_matches_jax_and_fold():
    params, bn = jax_params()
    x = np.random.default_rng(2).normal(size=(64, 34)).astype(np.float32)
    ref, _ = jax_loco_forward(params, bn, x, train=False)
    tp, tbn = params_from_numpy(params, bn)
    out = loco_forward(tp, tbn, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    folded = folded_forward(fold_eval_params(tp, tbn), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(folded, out, atol=ATOL)


def test_init_shapes_and_torch_linear_bounds():
    params, bn = init_loco_params(3, 34, 9, 128, 3)
    assert params['w1']['w'].shape == (34, 128)
    assert params['stages']['w1']['w'].shape == (3, 128, 128)
    assert params['w_fin']['w'].shape == (128, 8) and params['w_aux']['w'].shape == (128, 1)
    assert float(params['w1']['w'].abs().max()) <= 1 / np.sqrt(34)
    assert float(params['w2']['w'].abs().max()) <= 1 / np.sqrt(128)
    assert bn['stages']['bn2']['var'].shape == (3, 128)
    again, _ = init_loco_params(3, 34, 9, 128, 3)
    assert torch.equal(again['w2']['w'], params['w2']['w'])


@pytest.mark.parametrize('name', ['model_tpu.pkl', 'model_torch.pkl'])
def test_load_checkpoint_equals_jax(name):
    """model_tpu.pkl is a trainer checkpoint whose opt_state references optax:
    the port reads it through its inert-placeholder unpickler."""
    path = os.path.join(GOLD, name)
    jp, jbn, _ = jax_load(path)
    tp, tbn, _ = load_checkpoint(path)
    for ref, ours in ((jp, tp), (jbn, tbn)):
        rl, ol = _leaves(ref), _leaves(ours)
        assert rl.keys() == ol.keys()
        for k in rl:
            np.testing.assert_array_equal(ol[k], rl[k], err_msg=k)


def test_save_checkpoint_round_trips_through_both_packages(tmp_path):
    params, bn = jax_params()
    tp, tbn = params_from_numpy(params, bn)
    path = str(tmp_path / 'ported.pkl')
    save_checkpoint(path, tp, tbn, meta={'epoch': 1})
    for loaded in (jax_load(path), load_checkpoint(path)):
        lp, lbn, meta = loaded
        assert meta == {'epoch': 1}
        for ref, ours in ((params, lp), (bn, lbn)):
            rl, ol = _leaves(ref), _leaves(ours)
            for k in rl:
                np.testing.assert_array_equal(ol[k], rl[k], err_msg=k)
    with pytest.raises(NotImplementedError):
        save_checkpoint(str(tmp_path / 'x.orbax'), tp, tbn)
