"""Port's fused force module for every edge configuration: the plain version
against the JAX head-packed Pallas kernel (interpret mode), against the JAX
score network for all eight edge/absolute-coordinate combinations and on the
staged chignolin weights; the slice as a whole (ten Langevin steps through
``fused="always"``, a short reverse chain through ``kernel="packed"``); the
flat buffer's layout; the wrapper's CPU/CUDA routing. The CUDA kernel itself
runs only on the card (``chip_smoke.py`` holds it against the plain
version)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.dynamics import integrators as jint
from twoforone_tpu.dynamics.langevin import LangevinDiffusion as JLD
from twoforone_tpu.dynamics.langevin import make_diffusion_force_fn as jforce
from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
from twoforone_tpu.models.graph_transformer import score_forward as jscore
from twoforone_tpu.ops.fused_score import make_fused_force_kernel as jmake_kernel
from twoforone_tpu.ops.geometry import center_zero as jcenter
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.models.graph_transformer import GraphTransformer
from twoforone_torch.ops import fused_score as fs
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.utils.artifacts import load_ema_params

PRODUCTION = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
DEFAULT = dict(use_intrinsic_coords=False, use_abs_coords=True, use_distances=True)
# (use_intrinsic_coords, use_distances, use_abs_coords): four edge
# configurations, each with and without absolute coordinates.
COMBOS = list(itertools.product([True, False], [True, False], [True, False]))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jmodel, seed):
    n = jmodel.num_beads
    return jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), jnp.zeros((1,)),
                       return_energy=True)["params"]


def _pair(n, hidden, layers, heads=8, dim_head=64, **edges):
    """The same architecture in both packages."""
    jm = JGT(num_beads=n, hidden_nf=hidden, n_layers=layers, heads=heads, dim_head=dim_head,
             **edges)
    tm = GraphTransformer(n, hidden, layers, heads=heads, dim_head=dim_head, **edges)
    return jm, tm


@pytest.fixture(scope="module")
def small():
    """Production configuration, N=10, hidden 16, 1 layer (8 x 64 heads),
    ``model.init`` weights, 8 chains."""
    jm, tm = _pair(10, 16, 1, **PRODUCTION)
    jp = _init(jm, 0)
    folded = fs.augment_params(tm, _np_tree(jp), "cpu")
    x = np.random.default_rng(0).normal(size=(8, 10, 3)).astype(np.float32)
    return jm, jp, folded, x


@pytest.mark.parametrize("runtime_t", [False, True])
def test_reference_matches_jax_interpret_kernel(small, runtime_t):
    """The head-packed Pallas kernel in interpret mode (small
    ``block_chains``), fixed t (0.02) and runtime t (0.37). Tolerance 1e-5
    relative to the largest force: the packed body and the transcription run
    the same f32 arithmetic in another order (the kernel's rational erf is
    within 1.5e-7 of erff); measured 8e-7."""
    jm, jp, folded, x = small
    if runtime_t:
        kern = jmake_kernel(jm, jp, None, block_chains=4, interpret=True)
        ref, t = np.asarray(kern(jnp.asarray(x), 0.37)), 0.37
    else:
        kern = jmake_kernel(jm, jp, 0.02, block_chains=4, interpret=True)
        ref, t = np.asarray(kern(jnp.asarray(x))), 0.02
    out = fs.fused_force_reference(torch.from_numpy(x), t, folded).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("intrinsic,distances,abs_coords", COMBOS)
def test_reference_matches_jax_score_forward(intrinsic, distances, abs_coords):
    """All four edge configurations with and without absolute coordinates,
    against the JAX network with ``jax.grad`` (the Pallas kernel's own
    reference). N=7, hidden 16, 2 layers, 2 x 8 heads, ``model.init``
    weights with the biases and LayerNorm scales perturbed (flax starts them
    at 0 and 1, which would hide a dropped bias). Tolerance 2e-5 relative to
    the largest force, the bound the port's network is held to: squared
    distances enter the scores with O(1) random coefficients, so the softmax
    is sharp and f32 rounding in the scores is amplified (measured up to
    4.3e-6 there, 1e-6 without distances). The
    configuration with no edge features and no absolute coordinates has an
    energy that ignores x: both give exactly zero."""
    edges = dict(use_intrinsic_coords=intrinsic, use_distances=distances,
                 use_abs_coords=abs_coords)
    jm, tm = _pair(7, 16, 2, heads=2, dim_head=8, **edges)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "kernel" in str(path[-1]) else
        a + 0.3 * rng.normal(size=a.shape).astype(np.float32),
        _np_tree(_init(jm, 1)))
    folded = fs.augment_params(tm, jp, "cpu")
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    score = jax.jit(lambda p, xx, tt: jscore(jm, p, xx, tt))
    for t in (0.02, 0.6):
        ref = np.asarray(score(jp, jnp.asarray(x), jnp.full((5,), t, jnp.float32)))
        out = fs.fused_force_reference(torch.from_numpy(x), t, folded).numpy()
        if not (intrinsic or distances or abs_coords):
            assert not ref.any() and not out.any()
        else:
            np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_reference_on_chain10_matches_cl_reference_and_jax():
    """chain10 weights at full width (production configuration): the plain
    version equals the chain-lane module's plain version (two transcriptions
    of one function, 1e-5 of the largest force) and the JAX network (2e-5,
    the bound the port's own network is held to)."""
    from __graft_entry__ import _flagship
    from twoforone_tpu.utils.artifacts import load_ema_params as jload

    params = load_ema_params("chain10")
    model = GraphTransformer(10, 64, 3, **PRODUCTION)
    folded = fs.augment_params(model, params, "cpu")
    folded_cl = fcl.augment_params_cl(model, params, "cpu")
    jmodel, jgd = _flagship()
    jparams = jload(jgd, "chain10")
    score = jax.jit(lambda p, xx, tt: jscore(jmodel, p, xx, tt))
    x = np.random.default_rng(1).normal(size=(32, 10, 3)).astype(np.float32)
    for t in (0.02, 0.5):
        out = fs.fused_force_reference(torch.from_numpy(x), t, folded).numpy()
        cl = fcl.fused_force_cl_reference(torch.from_numpy(x), t, folded_cl).numpy()
        ref = np.asarray(score(jparams, jnp.asarray(x), jnp.full((32,), t, jnp.float32)))
        np.testing.assert_allclose(out, cl, atol=1e-5 * np.abs(cl).max(), rtol=0)
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("name", ["chain35", "chain56"])
def test_reference_on_staged_weights_matches_jax(name):
    """villin (N=35) and protein G (N=56) trained weights at full width, the
    models ``fused="always"`` sends to this kernel from the CLI: the plain
    version against the JAX network at fixed and runtime t, 4 chains. 2e-5
    of the largest force, as on chain10."""
    from test_torch_model import MORE_STAGED, jax_staged

    n, nf = MORE_STAGED[name]
    _, jparams, score = jax_staged(name, n, nf)
    folded = fs.augment_params(GraphTransformer(n, nf, 3, **PRODUCTION),
                               load_ema_params(name), "cpu")
    x = np.random.default_rng(5).normal(size=(4, n, 3)).astype(np.float32)
    for t in (0.02, 0.5):
        ref = np.asarray(score(jparams, jnp.asarray(x), jnp.full((4,), t, jnp.float32)))
        out = fs.fused_force_reference(torch.from_numpy(x), t, folded).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _default_edges_pair():
    """The upstream-default edge configuration (squared distances and
    absolute coordinates) at N=6, hidden 16, 1 layer, 2 x 8 heads, with
    ``model.init`` weights, as a diffusion object in both packages."""
    jm, tm = _pair(6, 16, 1, heads=2, dim_head=8, **DEFAULT)
    jp = _init(jm, 2)
    kw = dict(num_atoms=6, timesteps=8, norm_factor=2.0, loss_weights="ones")
    return JGD(model=jm, **kw), jp, GaussianDiffusion(model=tm, **kw), _np_tree(jp)


def test_ten_langevin_steps_through_always_match_jax_plain_path():
    """The slice as a whole, Langevin side: ``fused="always"`` on the CPU
    (the plain version) against the JAX package's ``fused="never"``, 10 BAOAB
    steps with the same injected noise on the default edge configuration.
    1e-4 of the largest coordinate, as for the other force paths (measured
    1.2e-7): per-step force differences of ~1e-6 relative compound over ten
    steps."""
    jgd, jparams, gd, params = _default_edges_pair()
    n = 6
    kw = dict(t=3, temp_data=300, temp_sim=300, dt=2e-3, masses=[12.0] * n, friction=1.0,
              kb="consistent", restraint_k=50.0, max_force=1e3)
    rng = np.random.default_rng(7)
    init = rng.normal(size=(8, n, 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * jgd.norm_factor
    noise = rng.normal(size=(10, 8, n, 3)).astype(np.float32)

    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, fused="never", **kw)
    sim = jd.sim
    x, v = jnp.asarray(init / jd.norm_factor), jnp.zeros((8, n, 3))
    force_fn = jax.jit(jforce(jgd, jparams, 3, jd.kb_inv / 300, fused="never"))
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        forces = jnp.clip(forces, -1e3, 1e3) - 50.0 * x
        x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                               sim.vscale, sim.noisescale, sim.beta)
    ref = np.asarray(x) * jd.norm_factor

    td = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                           fused="always", device="cpu", **kw)
    assert td.force_fn.mode == "always"
    draws = iter(torch.from_numpy(noise))
    td.sim._draw_noise = lambda like: next(draws)
    out = td.sample()
    assert out.shape == (8, n, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("steps", [None, 4])
def test_packed_sampler_matches_jax_sample(steps):
    """The slice as a whole, sampler side: ``kernel="packed"`` on the CPU
    against the JAX package's ``sample`` (its plain path) over the 8-step
    ancestral chain and a 4-step DDIM chain, with the noise the JAX chain
    draws from its key handed to the port. rtol/atol 1e-4 (measured 1e-6 of
    the largest coordinate; the JAX package's own fused-sampling test allows
    1e-3)."""
    from test_torch_diffusion import _jax_noise_hook

    jgd, jparams, gd, params = _default_edges_pair()
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jgd.sample(jparams, 4, key, sample_steps=steps))
    fn = gd.make_fused_sample_fn(params, 4, kernel="packed", sample_steps=steps, device="cpu")
    assert fn.kernel == "packed"
    before = fs.fused_force.launches
    out = fn(noise=_jax_noise_hook(key)).numpy()
    assert fs.fused_force.launches == before  # the plain version counts no launch
    assert out.shape == (4, 6, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("intrinsic,distances,abs_coords", COMBOS)
def test_flat_buffer_order_and_size(intrinsic, distances, abs_coords):
    """The kernel's flat buffer: per layer the documented order (``kc`` only
    with intrinsic coordinates, ``kd`` only with distances), then the
    globals (``wx`` only with absolute coordinates); its size is the sum of
    the pieces, and each piece sits where the order says."""
    n, c, layers, heads, dh = 5, 8, 2, 2, 4
    inner, ff = heads * dh, 4 * c
    _, tm = _pair(n, c, layers, heads=heads, dim_head=dh, use_intrinsic_coords=intrinsic,
                  use_distances=distances, use_abs_coords=abs_coords)
    from twoforone_torch.models.graph_transformer import init_params

    fw = fs.augment_params(tm, init_params(tm, 3), "cpu")
    order = fs.layer_order(intrinsic, distances)
    assert ("kc" in order) == intrinsic and ("kd" in order) == distances
    assert order.index("bqkv") < order.index("wo") and order[-4:] == (
        "wqkvT", "woT", "w1T", "w2T")
    per_layer = (2 * c + 3 * (c * inner + inner) + 3 * inner * intrinsic + inner * distances
                 + inner * c + c + 2 * c + 2 * c + c * ff + ff + ff * c + c + 2 * c
                 + 4 * c * inner + 2 * c * ff)
    assert fw.flat.numel() == layers * per_layer + n * c + 3 * c * abs_coords + 2 * c + 1
    assert fs.global_order(abs_coords) == (
        ("h0", "wx", "wt", "wdec", "bdec") if abs_coords else ("h0", "wt", "wdec", "bdec"))
    flat = fw.flat.numpy()
    layer1 = flat[per_layer:2 * per_layer]
    np.testing.assert_array_equal(layer1[:c], fw.layers[1]["ln1_g"].numpy())
    off = 2 * c + 3 * (c * inner + inner)
    if intrinsic:
        np.testing.assert_array_equal(layer1[off:off + 3 * inner],
                                      fw.layers[1]["kc"].numpy().ravel())
        off += 3 * inner
    if distances:
        np.testing.assert_array_equal(layer1[off:off + inner], fw.layers[1]["kd"].numpy())
        off += inner
    np.testing.assert_array_equal(layer1[off:off + inner * c], fw.layers[1]["wo"].numpy().ravel())
    np.testing.assert_array_equal(layer1[-ff * c:], fw.layers[1]["w2"].numpy().T.ravel())
    tail = flat[layers * per_layer:]
    np.testing.assert_array_equal(tail[:n * c], fw.glob["h0"].numpy().ravel())
    if abs_coords:
        np.testing.assert_array_equal(tail[n * c:n * c + 3 * c], fw.glob["wx"].numpy().ravel())
    assert tail[-1] == fw.glob["bdec"].item()


def test_wrapper_cpu_runs_plain_version_uncounted(small):
    _, _, folded, x = small
    xt = torch.from_numpy(x[:7])  # any chain count, no padding
    before = fs.fused_force.launches
    out = fs.fused_force(xt, 0.1, folded)
    assert fs.fused_force.launches == before
    torch.testing.assert_close(out, fs.fused_force_reference(xt, 0.1, folded), rtol=0, atol=0)
    fixed = fs.make_fused_force_kernel(
        GraphTransformer(10, 16, 1, **PRODUCTION),
        _np_tree(small[1]), 0.1, device="cpu")
    torch.testing.assert_close(fixed(xt), out, rtol=0, atol=0)


def test_augment_rejects_non_conservative_and_mismatched_weights():
    tm = GraphTransformer(5, 8, 1, conservative=False, heads=2, dim_head=4)
    with pytest.raises(ValueError, match="conservative"):
        fs.augment_params(tm, {}, "cpu")
    from twoforone_torch.models.graph_transformer import init_params

    with_abs = GraphTransformer(5, 8, 1, heads=2, dim_head=4, **DEFAULT)
    without = GraphTransformer(5, 8, 1, heads=2, dim_head=4, use_intrinsic_coords=False,
                               use_abs_coords=False, use_distances=True)
    with pytest.raises(ValueError, match="node embedding"):
        fs.augment_params(without, init_params(with_abs, 0), "cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """Kernel vs plain version on the card: chain10 weights (production
    configuration; 100 chains, and chain counts around the tile size that
    leave ragged tiles) within 1e-4 of the largest force, and the
    upstream-default configuration with seeded weights at chignolin width
    (ragged: 37 chains) against the float64 plain version, within the larger
    of 1e-4 and four times the float32 plain version's own distance to it
    (untrained weights make the scores large and both f32 versions lose
    digits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from twoforone_torch.models.graph_transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    model = GraphTransformer(10, 64, 3, **PRODUCTION)
    folded = fs.augment_params(model, load_ema_params("chain10"), "cuda")
    for chains in (100, 1, 3, 4, 5, 257, 1000, 1024):
        x = torch.from_numpy(rng.normal(size=(chains, 10, 3)).astype(np.float32)).cuda()
        for t in (0.02, 0.37):
            out = fs.fused_force(x, t, folded)
            ref = fs.fused_force_reference(x, t, folded)
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    model = GraphTransformer(10, 64, 3, **DEFAULT)
    params = init_params(model, 0)
    folded = fs.augment_params(model, params, "cuda")
    folded64 = fs.augment_params(model, params, "cuda", dtype=torch.float64)
    x = torch.from_numpy(rng.normal(size=(37, 10, 3)).astype(np.float32)).cuda()
    out = fs.fused_force(x, 0.37, folded)
    ref64 = fs.fused_force_reference(x.double(), 0.37, folded64)
    plain_err = (fs.fused_force_reference(x, 0.37, folded) - ref64).abs().max().item()
    torch.cuda.synchronize()
    scale = ref64.abs().max().item()
    assert (out - ref64).abs().max().item() <= max(1e-4 * scale, 4 * plain_err)
