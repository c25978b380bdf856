"""The plain-network force path (``fused="never"``) at villin's settings
against the JAX package: 35 beads with the staged chain35 weights at the
published widths (nf 128, 3 layers, 8 x 64 heads, intrinsic edges), the
Langevin noise level t=5 and 360 K. On the card the path gate sends every
production model over 32 beads to this path (``test_torch_dynamics.py``'s
gate table), so at the paper's 100 chains villin runs the plain network
inside the captured step.

torch and JAX draw different random numbers from the same seed, so the
steps' noise is made with numpy and injected on both sides, as in
``test_torch_dynamics.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_model import jax_staged
from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.dynamics import integrators as jint
from twoforone_tpu.dynamics.langevin import LangevinDiffusion as JLD
from twoforone_tpu.dynamics.langevin import make_diffusion_force_fn as jforce
from twoforone_tpu.ops.geometry import center_zero as jcenter
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.data.molecules import Molecules, norm_stds
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.models.graph_transformer import GraphTransformer
from twoforone_torch.utils.artifacts import load_ema_params

N, NF, LAYERS = 35, 128, 3
EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
NORM = norm_stds[Molecules.VILLIN]
T, TEMP = 5, 360
MAX_FORCE, RESTRAINT_K = 1e3, 50.0
SETTINGS = dict(t=T, temp_data=TEMP, temp_sim=TEMP, dt=2e-3, masses=[12.0] * N, friction=1.0,
                kb="consistent", restraint_k=RESTRAINT_K, max_force=MAX_FORCE)


@functools.lru_cache(maxsize=None)
def _jax_villin():
    jm, jparams, _ = jax_staged("chain35", N, NF)
    return JGD(model=jm, num_atoms=N, timesteps=1000, norm_factor=NORM, loss_weights="ones"), jparams


def _port_villin():
    gd = GaussianDiffusion(model=GraphTransformer(N, NF, LAYERS, **EDGES), num_atoms=N,
                           timesteps=1000, norm_factor=NORM, loss_weights="ones")
    return gd, load_ema_params("chain35")


def _start(chains, seed):
    rng = np.random.default_rng(seed)
    init = rng.normal(size=(chains, N, 3)).astype(np.float32)
    return (init - init.mean(axis=1, keepdims=True)) * np.float32(NORM), rng


def test_the_plain_force_at_villins_settings_matches_jax():
    """The force of ``LangevinDiffusion(fused="auto")`` (the plain network on
    the CPU) at t=5 and 360 K, 8 chains from a spread start where the clamp
    has work: its scale is JAX's Python float, and the force, raw and
    clamped at ``max_force``, is within 2e-5 of the largest of JAX's, the
    score network's tolerance on the staged weights (the two packages sum in
    another order)."""
    jgd, jparams = _jax_villin()
    gd, params = _port_villin()
    init, _ = _start(8, 11)
    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, **SETTINGS)
    td = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                           fused="auto", device="cpu", **SETTINGS)
    assert td.force_fn.mode == "never"
    expected_scale = 1.0 / (jd.kb_inv / TEMP * float(jgd.buffers.sqrt_one_minus_alphas_cumprod[T]))
    assert td.force_fn.scale == expected_scale
    x = init / np.float32(NORM)
    _, jf = jax.jit(jforce(jgd, jparams, T, jd.kb_inv / TEMP))(jnp.asarray(x))
    _, tf = td.force_fn(torch.from_numpy(x))
    jf, tf = np.asarray(jf), tf.numpy()
    assert (np.abs(jf) > MAX_FORCE).any()
    np.testing.assert_allclose(tf, jf, atol=2e-5 * np.abs(jf).max(), rtol=0)
    clamped = np.clip(jf, -MAX_FORCE, MAX_FORCE)
    np.testing.assert_allclose(np.clip(tf, -MAX_FORCE, MAX_FORCE), clamped,
                               atol=2e-5 * np.abs(clamped).max(), rtol=0)


def test_ten_langevin_steps_of_the_auto_path_match_jax_loop():
    """8 chains, 10 BAOA(F)B steps with the same injected noise: the port's
    ``fused="auto"`` loop against the JAX package's plain force in its own
    loop. 1e-4 of the largest coordinate, as for chignolin and trp-cage:
    per-step force differences of ~1e-6 relative compound over ten steps,
    which at t=5 have not yet amplified them past it."""
    jgd, jparams = _jax_villin()
    gd, params = _port_villin()
    init, rng = _start(8, 12)
    noise = rng.normal(size=(10, 8, N, 3)).astype(np.float32)

    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, **SETTINGS)
    sim = jd.sim
    x, v = jnp.asarray(init / jd.norm_factor), jnp.zeros((8, N, 3))
    force_fn = jax.jit(jforce(jgd, jparams, T, jd.kb_inv / TEMP, fused="never"))
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        forces = jnp.clip(forces, -MAX_FORCE, MAX_FORCE) - RESTRAINT_K * x
        x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                               sim.vscale, sim.noisescale, sim.beta)
    ref = np.asarray(x) * jd.norm_factor

    td = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                           fused="auto", device="cpu", **SETTINGS)
    assert td.force_fn.mode == "never"
    draws = iter(torch.from_numpy(noise))
    td.sim._draw_noise = lambda like: next(draws)
    out = td.sample()
    assert out.shape == (8, N, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
