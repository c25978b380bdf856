"""Port's integrators and Langevin driver against the JAX package.

torch and JAX draw different random numbers from the same seed, so the
parity tests make the noise with numpy and inject it on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.dynamics import integrators as jint
from twoforone_tpu.dynamics.langevin import LangevinDiffusion as JLD
from twoforone_tpu.dynamics.langevin import make_diffusion_force_fn as jforce
from twoforone_tpu.ops.geometry import center_zero as jcenter
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.dynamics import integrators as tint
from twoforone_torch.dynamics.langevin import (
    LangevinDiffusion,
    make_diffusion_force_fn,
    resolve_fused_mode,
)
from twoforone_torch.models.graph_transformer import GraphTransformer
from twoforone_torch.utils.artifacts import load_ema_params

N = 10


@functools.lru_cache(maxsize=None)
def _jax_chain10():
    from __graft_entry__ import _flagship
    from twoforone_tpu.utils.artifacts import load_ema_params as jload

    _, gd = _flagship()
    return gd, jload(gd, "chain10")


def _port_chain10():
    model = GraphTransformer(N, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    gd = GaussianDiffusion(model=model, num_atoms=N, timesteps=1000,
                           norm_factor=3.113133430480957, loss_weights="higheruntil_100")
    return gd, load_ema_params("chain10")


def test_baoab_and_overdamped_steps_match_jax():
    """Elementwise f32 arithmetic in the same order: agreement to 1 ulp-ish
    (atol 1e-6 on O(1) values)."""
    rng = np.random.default_rng(0)
    x, v, f, noise = (rng.normal(size=(8, 5, 3)).astype(np.float32) for _ in range(4))
    masses = np.array([12.0, 12.0, 13.0, 12.0, 14.0], np.float32)
    args = (2e-3, 0.998, 0.0632, 1.7)
    jx, jv = jint.baoab_step(*map(jnp.asarray, (x, v, f, noise)), args[0],
                             jnp.asarray(masses), *args[1:])
    tx, tv = tint.baoab_step(*map(torch.from_numpy, (x, v, f, noise)), args[0],
                             torch.from_numpy(masses), *args[1:])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    jo = jint.overdamped_step(jnp.asarray(x), jnp.asarray(f), jnp.asarray(noise), 0.01, 2.0)
    to = tint.overdamped_step(torch.from_numpy(x), torch.from_numpy(f),
                              torch.from_numpy(noise), 0.01, 2.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)


BENCH = dict(t=20, temp_data=340, temp_sim=340, dt=2e-3, masses=[12.0] * N,
             friction=1.0, kb="consistent", restraint_k=50.0, max_force=1e3)


@functools.lru_cache(maxsize=None)
def _jax_ten_steps():
    """Start, injected noise and the JAX loop's final coordinates (shared by
    both parametrisations)."""
    jgd, jparams = _jax_chain10()
    rng = np.random.default_rng(5)
    init = rng.normal(size=(16, N, 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * jgd.norm_factor
    noise = rng.normal(size=(10, 16, N, 3)).astype(np.float32)

    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, **BENCH)
    sim = jd.sim
    x, v = jnp.asarray(init / jd.norm_factor), jnp.zeros((16, N, 3))
    force_fn = jax.jit(jforce(jgd, jparams, 20, jd.kb_inv / 340))
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        forces = jnp.clip(forces, -1e3, 1e3) - 50.0 * x
        x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                               sim.vscale, sim.noisescale, sim.beta)
    return init, noise, np.asarray(x) * jd.norm_factor


@pytest.mark.parametrize("fused", ["never", "cl", "always"])
def test_ten_langevin_steps_match_jax_loop(fused):
    """bench.py's settings on chain10 forces, 16 chains, 10 BAOAB steps with
    the same injected noise. fused="cl" and fused="always" run their fused
    kernels' plain versions (CPU tensors). Tolerance 1e-4 relative to the largest
    coordinate: per-step force differences of ~1e-6 relative compound over
    ten steps."""
    gd, params = _port_chain10()
    init, noise, ref = _jax_ten_steps()

    td = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                           fused=fused, device="cpu", **BENCH)
    draws = iter(torch.from_numpy(noise))
    td.sim._draw_noise = lambda like: next(draws)
    assert td.force_fn.mode == fused
    out = td.sample()
    assert out.shape == (16, N, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_fused_default_is_the_jax_packages():
    """A call that names no force path runs the same one in both packages:
    the plain network. Read from the signatures, since on the CPU both
    resolve every default to the plain network anyway."""
    import inspect

    ours = inspect.signature(LangevinDiffusion).parameters["fused"].default
    theirs = inspect.signature(JLD).parameters["fused"].default
    assert ours == theirs == "never"


@pytest.mark.parametrize("kb", ["consistent", "kcal"])
def test_driver_units_auto_dt_and_force_scale_match_jax(kb):
    """kb_inv, auto-dt (dt=None) with dt_scale, beta and the force scale are
    the same Python floats as JAX's (they read the same float32 buffers);
    forces agree to the score-net tolerance."""
    jgd, jparams = _jax_chain10()
    gd, params = _port_chain10()
    init = np.random.default_rng(1).normal(size=(4, N, 3)).astype(np.float32)
    kw = dict(n_timesteps=20, save_interval=10, t=20, temp_data=340, temp_sim=360,
              dt=None, masses=[12.0] * N, friction=1.0, kb=kb, log=False, dt_scale=0.5)
    jd = JLD(jgd, jparams, init, **kw)
    td = LangevinDiffusion(gd, params, init, device="cpu", **kw)
    assert td.kb_inv == jd.kb_inv
    assert td.sim.dt == jd.sim.dt
    assert td.sim.beta == jd.sim.beta
    assert td.sim.vscale == jd.sim.vscale and td.sim.noisescale == jd.sim.noisescale
    expected_scale = 1.0 / (jd.kb_inv / 340 * float(jgd.buffers.sqrt_one_minus_alphas_cumprod[20]))
    assert td.force_fn.scale == expected_scale
    x = init / gd.norm_factor
    _, jf = jax.jit(jforce(jgd, jparams, 20, jd.kb_inv / 340))(jnp.asarray(x))
    _, tf = td.force_fn(torch.from_numpy(x))
    jf = np.asarray(jf)
    np.testing.assert_allclose(tf.numpy(), jf, atol=2e-5 * np.abs(jf).max(), rtol=0)


EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)


@pytest.mark.parametrize("n_beads,n_chains,device,expected", [
    (10, 100, "cuda", "cl"),
    (20, 1024, "cuda", "clx"),
    (20, 256, "cuda", "clx"),
    (20, 100, "cuda", "never"),  # below the gate's chain count
    (20, None, "cuda", "never"),
    (56, 1024, "cuda", "never"),  # above CLX_MAX_N
    (10, 100, "cpu", "never"),
    (20, 1024, "cpu", "never"),
])
def test_auto_gate_matches_jax_package(n_beads, n_chains, device, expected):
    """The table of tests/test_fused_score.py's gate test, for the port's
    ``resolve_fused_mode`` (the device is given as a string: no card
    needed), and the same answers from the JAX package's own gate."""
    from twoforone_tpu.dynamics.langevin import resolve_fused_mode as jresolve
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT

    model = GraphTransformer(n_beads, 8, 1, heads=2, dim_head=4, **EDGES)
    assert resolve_fused_mode(model, "auto", n_chains, device) == expected
    backend = "tpu" if device == "cuda" else "cpu"  # "any accelerator" on the JAX side
    jmodel = JGT(num_beads=n_beads, hidden_nf=8, n_layers=1, **EDGES)
    assert jresolve(jmodel, "auto", n_chains, backend) == expected


def test_gate_passes_explicit_modes_and_rejects_other_edge_configs():
    model = GraphTransformer(20, 8, 1, heads=2, dim_head=4, **EDGES)
    for mode in ("cl", "clx", "never", "always"):
        assert resolve_fused_mode(model, mode, 8, "cpu") == mode
    other = GraphTransformer(20, 8, 1, heads=2, dim_head=4, use_intrinsic_coords=True,
                             use_abs_coords=True, use_distances=False)
    assert resolve_fused_mode(other, "auto", 1024, "cuda") == "never"


OTHER_EDGES = [  # (use_intrinsic_coords, use_distances): every edge configuration
    (True, False), (False, True), (True, True), (False, False)]


@pytest.mark.parametrize("abs_coords", [False, True])
@pytest.mark.parametrize("intrinsic,distances", OTHER_EDGES)
def test_auto_gate_for_every_edge_configuration(intrinsic, distances, abs_coords):
    """Off the card "auto" is the plain path whatever the edge configuration;
    on the card only the production configuration gets a kernel from the
    Langevin gate, and the other seven run the plain network (the JAX
    package's gate: "always" is opt-in)."""
    from twoforone_tpu.dynamics.langevin import resolve_fused_mode as jresolve
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT

    kw = dict(use_intrinsic_coords=intrinsic, use_distances=distances,
              use_abs_coords=abs_coords)
    model = GraphTransformer(10, 8, 1, heads=2, dim_head=4, **kw)
    jmodel = JGT(num_beads=10, hidden_nf=8, n_layers=1, **kw)
    production = intrinsic and not distances and not abs_coords
    assert model.is_production_edge_config == production
    assert resolve_fused_mode(model, "auto", 1024, "cpu") == "never"
    assert jresolve(jmodel, "auto", 1024, "cpu") == "never"
    expected = "cl" if production else "never"
    assert resolve_fused_mode(model, "auto", 1024, "cuda") == expected
    assert jresolve(jmodel, "auto", 1024, "tpu") == expected
    assert resolve_fused_mode(model, "always", 1024, "cpu") == "always"


@pytest.mark.parametrize("fused,match", [("mosaic", "unknown fused mode"),
                                         ("always", "conservative")])
def test_unknown_force_path_and_non_conservative_always_raise(fused, match):
    """An unknown mode raises and names the modes; fused="always" on a model
    that predicts noise instead of an energy raises rather than falling
    through to another path."""
    gd, params = _port_chain10()
    if fused == "always":
        model = GraphTransformer(N, 64, 3, conservative=False, **EDGES)
        gd = GaussianDiffusion(model=model, num_atoms=N, timesteps=1000, norm_factor=3.1)
    with pytest.raises(ValueError, match=match):
        make_diffusion_force_fn(gd, params, 20, 1.0, fused=fused, device="cpu")


@pytest.mark.parametrize("intrinsic,distances", OTHER_EDGES)
def test_always_force_fn_matches_plain_network_for_every_edge_configuration(intrinsic,
                                                                            distances):
    """fused="always" (on the CPU: the kernel's plain version) gives the
    forces of fused="never" for each edge configuration with absolute
    coordinates, seeded weights. 1e-4 of the largest force: two float32
    evaluations of one network, and with squared distances on untrained
    weights (an edge embedding of fan-in 1 has unit variance) the scores are
    large and the softmax sharp, which costs digits (measured 3e-5 there,
    1e-6 without distances)."""
    from twoforone_torch.models.graph_transformer import init_params

    model = GraphTransformer(6, 16, 2, heads=2, dim_head=8, use_intrinsic_coords=intrinsic,
                             use_distances=distances, use_abs_coords=True)
    gd = GaussianDiffusion(model=model, num_atoms=6, timesteps=50, norm_factor=2.0)
    params = init_params(model, 4)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 6, 3)).astype(np.float32))
    fns = {mode: make_diffusion_force_fn(gd, params, 5, 1.7, fused=mode, device="cpu")
           for mode in ("always", "never")}
    assert fns["always"].mode == "always" and fns["always"].scale == fns["never"].scale
    _, got = fns["always"](x)
    _, ref = fns["never"](x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


def test_ten_langevin_steps_trp_cage_clx_match_jax_loop():
    """bench.py's trp-cage settings (chain20 weights, t=15, 290 K), 8 chains,
    10 BAOAB steps with the same injected noise: the port's clx path (on the
    CPU its attention core is the plain version) against the JAX package's
    plain path, which is what the JAX gate gives on the CPU. 1e-4 of the
    largest coordinate, as for chignolin."""
    from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
    from twoforone_tpu.utils.artifacts import load_ema_params as jload

    n, norm = 20, 5.08211088180542
    kw = dict(t=15, temp_data=290, temp_sim=290, dt=2e-3, masses=[12.0] * n, friction=1.0,
              kb="consistent", restraint_k=50.0, max_force=1e3)
    jgd = JGD(model=JGT(num_beads=n, hidden_nf=128, n_layers=3, conservative=True, **EDGES),
              num_atoms=n, timesteps=1000, norm_factor=norm, loss_weights="higheruntil_100")
    jparams = jload(jgd, "chain20")
    gd = GaussianDiffusion(model=GraphTransformer(n, 128, 3, **EDGES), num_atoms=n,
                           timesteps=1000, norm_factor=norm, loss_weights="higheruntil_100")
    rng = np.random.default_rng(6)
    init = rng.normal(size=(8, n, 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * norm
    noise = rng.normal(size=(10, 8, n, 3)).astype(np.float32)

    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, **kw)
    sim = jd.sim
    x, v = jnp.asarray(init / jd.norm_factor), jnp.zeros((8, n, 3))
    force_fn = jax.jit(jforce(jgd, jparams, 15, jd.kb_inv / 290, fused="never"))
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        forces = jnp.clip(forces, -1e3, 1e3) - 50.0 * x
        x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                               sim.vscale, sim.noisescale, sim.beta)
    ref = np.asarray(x) * jd.norm_factor

    td = LangevinDiffusion(gd, load_ema_params("chain20"), init, n_timesteps=10,
                           save_interval=10, log=False, fused="clx", device="cpu", **kw)
    assert td.force_fn.mode == "clx"
    draws = iter(torch.from_numpy(noise))
    td.sim._draw_noise = lambda like: next(draws)
    out = td.sample()
    assert out.shape == (8, n, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def _harmonic(x):
    return 0.5 * torch.sum(x**2, dim=(1, 2)), -x


@pytest.mark.parametrize("friction", [1.0, None])
def test_resume_equals_uninterrupted_run(friction, tmp_path):
    """state/load_state across a fresh object continues the same trajectory
    bit for bit (generator state included); chunking is invisible too."""
    init = np.random.default_rng(2).normal(size=(6, 4, 3)).astype(np.float32)
    kw = dict(force_fn=_harmonic, initial_coordinates=init, dt=0.01, beta=1.0,
              friction=friction, masses=[1.0] * 4 if friction else None, length=200,
              save_interval=10, random_seed=7, device="cpu", restraint_k=0.5,
              max_force=3.0)
    full = tint.LangevinSimulation(**kw)
    ref = full.simulate()

    first = tint.LangevinSimulation(steps_per_chunk=30, **kw)
    a = first.simulate(sub_interval=100)
    state = first.state
    second = tint.LangevinSimulation(**kw)
    second.load_state(state)
    b = second.simulate(sub_interval=100)
    np.testing.assert_array_equal(np.concatenate([a, b], axis=1), ref)
    np.testing.assert_array_equal(second.state["x"], full.state["x"])
    assert second.state["t"] == 200
    if friction:
        assert second.kinetic_energies.shape == (6, 10)


def test_export_and_tempering_ramp(tmp_path):
    init = np.random.default_rng(3).normal(size=(3, 4, 3)).astype(np.float32)
    sim = tint.LangevinSimulation(
        force_fn=_harmonic, initial_coordinates=init, dt=0.01, beta=1.0, friction=1.0,
        masses=[1.0] * 4, length=40, save_interval=10, export_interval=20,
        filename=str(tmp_path / "run"), save_forces=True, device="cpu", random_seed=1,
    )
    traj = sim.simulate(reference_beta=0.5)
    assert traj.shape == (3, 4, 4, 3) and np.isfinite(traj).all()
    for k in ("000", "001"):
        coords = np.load(tmp_path / f"run_coords_{k}.npy")
        assert coords.shape == (3, 2, 4, 3)
        assert np.load(tmp_path / f"run_forces_{k}.npy").shape == (3, 2, 4, 3)
        assert np.load(tmp_path / f"run_kineticenergy_{k}.npy").shape == (3, 2)
    np.testing.assert_array_equal(np.load(tmp_path / "run_coords_001.npy"), traj[:, 2:])
