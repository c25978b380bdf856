"""Port's fused force kernel module: the plain version against the JAX
chain-lane Pallas kernel (interpret mode) and against the port's own score
network; the wrapper's CPU/CUDA routing. The CUDA kernel itself runs only on
the card (``chip_smoke.py`` phase 2 holds it against the plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.ops.fused_score_cl import make_fused_force_kernel_cl
from twoforone_torch.models.graph_transformer import GraphTransformer, score_forward
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.utils.artifacts import load_ema_params
from twoforone_torch.utils.convert import params_from_jax


@pytest.fixture(scope="module")
def small():
    """N=10, hidden 16, 1 layer (8 x 64 heads), random weights, 128 chains."""
    jm = JGT(num_beads=10, hidden_nf=16, n_layers=1, use_intrinsic_coords=True,
             use_abs_coords=False, use_distances=False)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 3)), jnp.zeros((1,)),
                 return_energy=True)["params"]
    tm = GraphTransformer(10, 16, 1, use_intrinsic_coords=True, use_abs_coords=False,
                          use_distances=False)
    folded = fcl.augment_params_cl(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(0).normal(size=(128, 10, 3)).astype(np.float32)
    return jm, jp, folded, x


@pytest.mark.parametrize("runtime_t", [False, True])
def test_reference_matches_jax_interpret_kernel(small, runtime_t):
    """Fixed t (0.02) and runtime t (0.37). Tolerance 1e-5 relative to the
    largest force: the Pallas body and the transcription run the same f32
    arithmetic in another order (and K1's rational erf is within 1.5e-7)."""
    jm, jp, folded, x = small
    if runtime_t:
        kern = make_fused_force_kernel_cl(jm, jp, None, interpret=True)
        ref, t = np.asarray(kern(jnp.asarray(x), 0.37)), 0.37
    else:
        kern = make_fused_force_kernel_cl(jm, jp, 0.02, interpret=True)
        ref, t = np.asarray(kern(jnp.asarray(x))), 0.02
    out = fcl.fused_force_cl_reference(torch.from_numpy(x), t, folded).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_reference_matches_port_score_forward_chain10():
    """chain10 weights at full width: the folded transcription equals the
    plain module with autograd. Tolerance 2e-5 relative to the largest force
    (the folding reassociates the edge terms)."""
    params = load_ema_params("chain10")
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    model.load_state_dict(params_from_jax(params))
    folded = fcl.augment_params_cl(model, params, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(32, 10, 3)).astype(np.float32))
    for t in (0.02, 0.5):
        ref = score_forward(model, x, torch.full((32,), t)).numpy()
        out = fcl.fused_force_cl_reference(x, t, folded).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("name", ["ala5"])
def test_reference_on_staged_weights_matches_jax(name):
    """The alanine-dipeptide weights (N=5, nf 64), which ``fused="auto"``
    sends to this kernel: the plain version against the JAX network at fixed
    and runtime t, 16 chains. 2e-5 of the largest force."""
    from test_torch_model import MORE_STAGED, PRODUCTION, jax_staged

    n, nf = MORE_STAGED[name]
    _, jparams, score = jax_staged(name, n, nf)
    folded = fcl.augment_params_cl(GraphTransformer(n, nf, 3, **PRODUCTION),
                                   load_ema_params(name), "cpu")
    x = np.random.default_rng(6).normal(size=(16, n, 3)).astype(np.float32)
    for t in (0.02, 0.5):
        ref = np.asarray(score(jparams, jnp.asarray(x), jnp.full((16,), t, jnp.float32)))
        out = fcl.fused_force_cl_reference(torch.from_numpy(x), t, folded).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_wrapper_cpu_runs_plain_version_uncounted(small):
    _, _, folded, x = small
    xt = torch.from_numpy(x[:7])  # any chain count, no padding
    before = fcl.fused_force_cl.launches
    out = fcl.fused_force_cl(xt, 0.1, folded)
    assert fcl.fused_force_cl.launches == before
    torch.testing.assert_close(out, fcl.fused_force_cl_reference(xt, 0.1, folded),
                               rtol=0, atol=0)


def test_augment_rejects_other_edge_configs():
    tm = GraphTransformer(5, 8, 1, use_intrinsic_coords=True, use_abs_coords=True,
                          use_distances=False)
    with pytest.raises(ValueError, match="production edge config"):
        fcl.augment_params_cl(tm, {}, "cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """Kernel vs plain version on the card at chain10 width: 100 chains, and
    chain counts around the tile size that leave ragged tiles (1, T - 1, T,
    T + 1 for the 1000-chain tile size, 257, 1000, 1024, 4096). Tolerance 1e-4
    relative to the largest force: both are f32, summed in different orders.
    A chain alone gives the same bits as inside the largest batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = load_ema_params("chain10")
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    folded = fcl.augment_params_cl(model, params, "cuda")
    rng = np.random.default_rng(2)
    for chains in (100, 1, 3, 4, 5, 257, 1000, 1024, 4096):
        x = torch.from_numpy(rng.normal(size=(chains, 10, 3)).astype(np.float32)).cuda()
        for t in (0.02, 0.37):
            out = fcl.fused_force_cl(x, t, folded)
            ref = fcl.fused_force_cl_reference(x, t, folded)
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    alone = fcl.fused_force_cl(x[:3].contiguous(), 0.37, folded)
    torch.cuda.synchronize()
    assert torch.equal(alone, out[:3])
