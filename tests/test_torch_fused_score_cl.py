"""Port's fused force kernel module: the plain version against the JAX
chain-lane Pallas kernel (interpret mode) and against the port's own score
network; the wrapper's CPU/CUDA routing. The CUDA kernel itself runs only on
the card: the ``cuda`` tests here (``python -m pytest
tests/test_torch_fused_score_cl.py -m cuda --noconftest``; JAX is imported
only by the tests that compare with it) and ``chip_smoke.py`` phase 2 hold it
against the plain version, and its clustered launch against one block a
tile."""

import ctypes

import numpy as np
import pytest
import torch

from twoforone_torch.models.graph_transformer import GraphTransformer, score_forward
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.ops import tile_plan
from twoforone_torch.utils.artifacts import load_ema_params
from twoforone_torch.utils.convert import params_from_jax


@pytest.fixture(scope="module")
def small():
    """N=10, hidden 16, 1 layer (8 x 64 heads), random weights, 128 chains."""
    import jax
    import jax.numpy as jnp

    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT

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
    import jax.numpy as jnp

    from twoforone_tpu.ops.fused_score_cl import make_fused_force_kernel_cl

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
    import jax.numpy as jnp
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


def _chain10_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    return fcl.augment_params_cl(model, load_ema_params("chain10"), "cuda")


def _plan(chains, folded):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tile_plan.plan_tiles(chains, *fcl._dims(folded), sms,
                                resident_clusters=fcl._resident_clusters(fcl._lib()))


@pytest.mark.cuda
@pytest.mark.parametrize("chains,cluster", [(100, 2), (50, 4)])
def test_clustered_launch_gives_one_blocks_bits_on_card(monkeypatch, chains, cluster):
    """At 100 chains (50) the plan shares each tile among a cluster of 2 (4)
    blocks; the force has the bits of the launch with one block a tile
    (``plan_at`` forcing cluster 1 at the same tile size), at a fixed t and a
    runtime one, and is within 1e-4 of the plain version. Each clustered
    launch is counted as such."""
    folded = _chain10_on_card()
    x = torch.from_numpy(np.random.default_rng(chains).normal(size=(chains, 10, 3))
                         .astype(np.float32)).cuda()
    plan = _plan(chains, folded)
    assert plan.cluster == cluster and plan.chains_per_tile == 1
    for t in (0.02, 0.37):
        before = (fcl.fused_force_cl.launches, fcl.fused_force_cl.clustered)
        shared = fcl.fused_force_cl(x, t, folded)
        assert (fcl.fused_force_cl.launches - before[0],
                fcl.fused_force_cl.clustered - before[1]) == (1, 1)
        with monkeypatch.context() as m:
            m.setattr(fcl, "plan_tiles", lambda *a, **k: tile_plan.plan_at(1, *a))
            alone = fcl.fused_force_cl(x, t, folded)
        assert fcl.fused_force_cl.clustered - before[1] == 1
        ref = fcl.fused_force_cl_reference(x, t, folded)
        torch.cuda.synchronize()
        assert torch.equal(shared, alone)
        assert (shared - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_card_keeps_the_100_chain_clusters_resident():
    """The occupancy query covers the 100-chain plan: all 100 clusters of 2
    resident at once, and fewer than half as many of 4; the library's
    per-tile scratch and shared memory are the plan's."""
    folded = _chain10_on_card()
    lib = fcl._lib()
    plan = _plan(100, folded)
    assert (plan.cluster, plan.groups, plan.blocks) == (2, 100, 200)
    resident = {size: lib.fused_force_cl_resident_clusters(plan.row_blocks, size, plan.smem_bytes)
                for size in (2, 4)}
    assert resident[2] >= plan.groups and 0 < resident[4] <= resident[2] // 2
    for fn in (lib.fused_force_cl_scratch_floats, lib.fused_force_cl_smem_bytes):
        fn.restype = ctypes.c_longlong
    args = (*fcl._dims(folded), plan.chains_per_tile, plan.row_blocks)
    assert lib.fused_force_cl_scratch_floats(*args) == plan.scratch_floats
    assert lib.fused_force_cl_smem_bytes(*args) == plan.smem_bytes
