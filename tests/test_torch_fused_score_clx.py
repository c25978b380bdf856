"""Port's attention-core ("clx") force path against the JAX package's
(Pallas core in interpret mode) and against the port's own score network;
the staged trp-cage and BBA weights through the port's network against the
JAX one. On the CPU the port's attention core is its plain version."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.models.graph_transformer import score_forward as jscore
from twoforone_tpu.ops.fused_score_clx import make_clx_force_fn as jclx
from twoforone_tpu.utils.artifacts import load_ema_params as jload
from twoforone_torch.models.graph_transformer import GraphTransformer, score_forward
from twoforone_torch.ops import attention_cl_core as tcore
from twoforone_torch.ops.fused_score_clx import CLX_MAX_N, CLX_MIN_CHAINS, make_clx_force_fn
from twoforone_torch.utils.artifacts import load_ema_params
from twoforone_torch.utils.convert import params_from_jax

EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
N_SMALL, B_SMALL = 12, 130  # the JAX side pads 130 chains to 256; the port does not


@functools.lru_cache(maxsize=None)
def _small():
    """N=12, hidden 16, 2 layers (8 x 64 heads), random weights, 130 chains."""
    jm = JGT(num_beads=N_SMALL, hidden_nf=16, n_layers=2, **EDGES)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, N_SMALL, 3)), jnp.zeros((1,)),
                 return_energy=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, jp)
    tm = GraphTransformer(N_SMALL, 16, 2, **EDGES)
    x = np.random.default_rng(0).normal(size=(B_SMALL, N_SMALL, 3)).astype(np.float32)
    return jm, jp, tm, params, x


@pytest.mark.parametrize("runtime_t", [False, True])
def test_clx_matches_jax_interpret(runtime_t):
    """Fixed t (0.015) and runtime t (0.37), the runtime t handed to the
    port as a 0-d tensor as the samplers do. Tolerance 1e-5 relative to the
    largest force: the same f32 arithmetic in another order."""
    jm, jp, tm, params, x = _small()
    if runtime_t:
        ref = np.asarray(jax.jit(jclx(jm, jp, None, interpret=True))(jnp.asarray(x), 0.37))
        out = make_clx_force_fn(tm, params, None, "cpu")(torch.from_numpy(x),
                                                         torch.tensor(0.37))
    else:
        ref = np.asarray(jax.jit(jclx(jm, jp, 0.015, interpret=True))(jnp.asarray(x)))
        out = make_clx_force_fn(tm, params, 0.015, "cpu")(torch.from_numpy(x))
    assert out.shape == (B_SMALL, N_SMALL, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("t", [0.015, 0.5])
def test_clx_matches_port_score_forward(t):
    """The folded energy with the attention core equals the plain module
    with autograd, also under ``no_grad`` (the Langevin step loop). 2e-5 of
    the largest force: the folding reassociates the edge terms."""
    _, _, tm, params, x = _small()
    tm.load_state_dict(params_from_jax(params))
    xt = torch.from_numpy(x[:32])
    ref = score_forward(tm, xt, torch.full((32,), t)).numpy()
    with torch.no_grad():
        out = make_clx_force_fn(tm, params, t, "cpu")(xt).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_clx_on_cpu_counts_no_launch_and_needs_no_kernel_library():
    _, _, tm, params, x = _small()
    before = (tcore.cl_attention_core.launches_fwd, tcore.cl_attention_core.launches_bwd)
    fn = make_clx_force_fn(tm, params, None, "cpu")
    fn(torch.from_numpy(x[:3]), 0.1)
    assert (tcore.cl_attention_core.launches_fwd,
            tcore.cl_attention_core.launches_bwd) == before
    assert fn.folded.checked is False  # the fused kernel's library was never asked
    assert (CLX_MIN_CHAINS, CLX_MAX_N) == (256, 32)


def test_clx_rejects_other_edge_configs():
    tm = GraphTransformer(12, 8, 1, use_intrinsic_coords=True, use_abs_coords=True,
                          use_distances=False)
    with pytest.raises(ValueError, match="production edge config"):
        make_clx_force_fn(tm, {}, 0.1, "cpu")


STAGED = {  # artifact: (N, nf, norm_factor)
    "chain20": (20, 128, 5.08211088180542),
    "chain28": (28, 96, 6.294918537139893),
}


@pytest.mark.parametrize("name", sorted(STAGED))
def test_staged_weights_score_forward_matches_jax(name):
    """trp-cage (nf=128) and BBA (nf=96) trained weights at full width
    through the port's reader, mapping and network against the JAX network,
    4 chains. 2e-5 of the largest force, as at chignolin width."""
    n, nf, norm = STAGED[name]
    jm = JGT(num_beads=n, hidden_nf=nf, n_layers=3, conservative=True, **EDGES)
    jgd = JGD(model=jm, num_atoms=n, timesteps=1000, norm_factor=norm,
              loss_weights="higheruntil_100")
    jparams = jload(jgd, name)
    model = GraphTransformer(n, nf, 3, **EDGES)
    params = load_ema_params(name)
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, n, 3)).astype(np.float32)
    t = np.full((4,), 0.015, np.float32)
    ref = np.asarray(jax.jit(lambda p, x, t: jscore(jm, p, x, t))(
        jparams, jnp.asarray(x), jnp.asarray(t)))
    xt = torch.from_numpy(x)
    out = score_forward(model, xt, torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)
    clx = make_clx_force_fn(model, params, 0.015, "cpu")(xt).numpy()
    np.testing.assert_allclose(clx, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)
