"""Port's score network and attention ops against the JAX package.

Inputs come from numpy with a fixed seed and go to both sides. JAX runs on
the CPU at float32 "highest" matmul precision (tests/conftest.py), torch on
the CPU in float32; the two differ only in summation order, so forces agree
to a few float32 ulps of their magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.models.graph_transformer import score_forward as jscore
from twoforone_tpu.ops import attention as jattn
from twoforone_tpu.utils.artifacts import load_ema_params as jload
from twoforone_torch.models.graph_transformer import (
    GraphTransformer,
    init_params,
    score_forward,
)
from twoforone_torch.ops import attention as tattn
from twoforone_torch.utils.artifacts import load_ema_params
from twoforone_torch.utils.convert import params_from_jax


def _jit_score(jmodel):
    """JAX score_forward compiled once: far quicker on the CPU than eager
    op-by-op dispatch of the forward and its grad."""
    return jax.jit(lambda p, x, t: jscore(jmodel, p, x, t))


def test_score_forward_chain10_full_width():
    """chignolin width (N=10, nf=64, 3 layers, 8x64 heads), trained weights.
    Tolerance: 2e-5 relative to the largest force (f32 reduction order over
    widths up to 512)."""
    from __graft_entry__ import _flagship

    jmodel, gd = _flagship()
    jparams = jload(gd, "chain10")
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    model.load_state_dict(params_from_jax(load_ema_params("chain10")))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 10, 3)).astype(np.float32)
    t = np.full((16,), 0.02, np.float32)
    ref = np.asarray(_jit_score(jmodel)(jparams, jnp.asarray(x), jnp.asarray(t)))
    out = score_forward(model, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


# The staged artifacts no other parity test loads: alanine dipeptide (N=5,
# nf 64), villin (N=35, nf 128) and protein G (N=56, nf 128), all with the
# production edge configuration.
MORE_STAGED = {"ala5": (5, 64), "chain35": (35, 128), "chain56": (56, 128)}
PRODUCTION = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)


def jax_staged(name, n, nf):
    """The JAX network of a staged artifact with its EMA weights (restored
    by flax from the file) and its jitted score function."""
    import os

    from flax import serialization

    from twoforone_torch.utils.artifacts import trained_dir

    jm = JGT(num_beads=n, hidden_nf=nf, n_layers=3, conservative=True, **PRODUCTION)
    with open(os.path.join(trained_dir(name), "model-best.msgpack"), "rb") as f:
        jparams = serialization.msgpack_restore(f.read())["ema_params"]
    return jm, jparams, _jit_score(jm)


@pytest.mark.parametrize("name", sorted(MORE_STAGED))
def test_score_forward_staged_weights_full_width(name):
    """Trained weights at the published widths through the port's reader,
    mapping and network against the JAX network, 4 chains at t = 0.02 (the
    CLI's noise level) and 0.5. 2e-5 of the largest force, as on chain10."""
    n, nf = MORE_STAGED[name]
    _, jparams, score = jax_staged(name, n, nf)
    model = GraphTransformer(n, nf, 3, **PRODUCTION)
    model.load_state_dict(params_from_jax(load_ema_params(name)))
    x = np.random.default_rng(4).normal(size=(4, n, 3)).astype(np.float32)
    for t_norm in (0.02, 0.5):
        t = np.full((4,), t_norm, np.float32)
        ref = np.asarray(score(jparams, jnp.asarray(x), jnp.asarray(t)))
        out = score_forward(model, torch.from_numpy(x), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


EDGE_CONFIGS = [  # (use_intrinsic_coords, use_distances, use_abs_coords)
    (True, False, False),
    (False, True, True),
    (True, True, True),
    (False, False, True),
]


@pytest.mark.parametrize("geometric", [True, False])
@pytest.mark.parametrize("intrinsic,distances,abs_coords", EDGE_CONFIGS)
def test_score_forward_edge_configs(intrinsic, distances, abs_coords, geometric):
    """All four edge configs, geometric and general attention path, small
    random weights. Tolerance 2e-5 relative to the largest force: f32 sums in
    another order (squared-distance configs reach forces of ~50)."""
    jm = JGT(num_beads=5, hidden_nf=16, n_layers=2, use_intrinsic_coords=intrinsic,
             use_distances=distances, use_abs_coords=abs_coords, heads=2, dim_head=8,
             use_geometric_edges=geometric)
    jp = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 5, 3)), jnp.zeros((1,)),
                 return_energy=True)["params"]
    model = GraphTransformer(5, 16, 2, intrinsic, abs_coords, distances, True, 2, 8,
                             use_geometric_edges=geometric)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    t = rng.uniform(size=(4,)).astype(np.float32)
    ref = np.asarray(_jit_score(jm)(jp, jnp.asarray(x), jnp.asarray(t)))
    out = score_forward(model, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("has_diff,has_dist", [(True, False), (False, True), (True, True),
                                               (False, False)])
def test_attention_ops_match_jax(has_diff, has_dist):
    """The three attention functions on the same random inputs. Tolerance
    1e-5 absolute: outputs are O(1) sums of at most N*dh f32 products."""
    rng = np.random.default_rng(3)
    b, n, h, dh = 3, 6, 2, 8
    q, k, v = (rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    k_diff = rng.normal(size=(3, h, dh)).astype(np.float32) * 0.3 if has_diff else None
    k_dist = rng.normal(size=(h, dh)).astype(np.float32) * 0.1 if has_dist else None
    b_comb = rng.normal(size=(h, dh)).astype(np.float32)
    scale = dh**-0.5
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    for name in ("geometric_edge_attention", "geometric_edge_attention_packed"):
        ref = getattr(jattn, name)(J(q), J(k), J(v), J(x), J(k_diff), J(k_dist), J(b_comb), scale)
        out = getattr(tattn, name)(T(q), T(k), T(v), T(x), T(k_diff), T(k_dist), T(b_comb), scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, err_msg=name)
    edges = rng.normal(size=(b, n, n, 4)).astype(np.float32)
    w_e = rng.normal(size=(4, h, dh)).astype(np.float32) * 0.3
    ref = jattn.edge_biased_attention(J(q), J(k), J(v), J(edges), J(w_e), J(b_comb), scale)
    out = tattn.edge_biased_attention(T(q), T(k), T(v), T(edges), T(w_e), T(b_comb), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("abs_coords", [False, True])
@pytest.mark.parametrize("intrinsic,distances", [(True, False), (False, True), (True, True),
                                                 (False, False)])
def test_init_params_tree_equals_model_init(intrinsic, distances, abs_coords):
    """The port's seeded initializer gives the flax tree of ``model.init``:
    the same keys, shapes and dtypes for every edge configuration (the
    numbers differ: another generator), in flax's initializer families, and
    it loads into the port's module."""
    kw = dict(use_intrinsic_coords=intrinsic, use_distances=distances,
              use_abs_coords=abs_coords)
    jm = JGT(num_beads=6, hidden_nf=16, n_layers=2, heads=2, dim_head=8, **kw)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 3)), jnp.zeros((1,)),
                 return_energy=True)["params"]
    model = GraphTransformer(6, 16, 2, heads=2, dim_head=8, **kw)
    tp = init_params(model, 0)
    ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert got.keys() == ref.keys()
    for key, leaf in ref.items():
        assert got[key].shape == leaf.shape and got[key].dtype == leaf.dtype, key
        if key.endswith("['bias']") or key.endswith("_bias']"):
            assert not got[key].any() and not np.asarray(leaf).any(), key
        elif key.endswith("['scale']"):
            assert (got[key] == 1).all() and (np.asarray(leaf) == 1).all(), key
    # lecun-normal: variance 1 / fan_in, truncated at two standard deviations
    w = tp["layers_0_attn"]["to_kv"]["kernel"]  # (16, 32)
    assert abs(w.std() * 16**0.5 - 1.0) < 0.1
    assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / 16**0.5 + 1e-6
    assert not np.array_equal(tp["layers_0_attn"]["to_q"]["kernel"],
                              init_params(model, 1)["layers_0_attn"]["to_q"]["kernel"])
    model.load_state_dict(params_from_jax(tp))  # strict: every key and shape
