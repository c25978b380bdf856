"""Diffusion-model force field -> Langevin dynamics driver (port of
``dynamics/langevin.py``).

- :func:`make_diffusion_force_fn` turns the learned score at one fixed noise
  level ``t`` into a CG force field,
  ``F = -eps_hat(x, t) / kbt_inv / sqrt(1 - alpha_bar_t)``.
- :class:`LangevinDiffusion` handles units (KB in g/mol, Angstrom, ps, K),
  the norm-factor algebra and auto-dt, and runs BAOA(F)B.

Force paths (``fused``): ``"cl"`` is the fused CUDA force kernel
(:mod:`twoforone_torch.ops.fused_score_cl`), ``"clx"`` the attention-core
kernel pair inside an eager energy (:mod:`twoforone_torch.ops.fused_score_clx`),
``"always"`` the fused CUDA force kernel for every edge configuration
(:mod:`twoforone_torch.ops.fused_score`), ``"never"`` the plain
``GraphTransformer`` with autograd, and ``"auto"`` picks by the JAX package's
gate (:func:`resolve_fused_mode`), which never picks ``"always"``: a model
with another edge configuration than the production one runs the plain
network unless the caller asks for the kernel. On the card every path runs
inside the simulation's captured step
(:class:`~twoforone_torch.dynamics.integrators.LangevinSimulation`).

With a ``mesh`` (:mod:`twoforone_torch.parallel.mesh`) each rank runs its
share of the chains through its own kernel call, and ``"auto"`` sees the
chains of one rank, as the JAX package's gate sees the chains of one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from twoforone_torch.data.molecules import AVOGADRO, JPERKCAL, KB, KBOLTZMANN
from twoforone_torch.dynamics.integrators import LangevinSimulation
from twoforone_torch.parallel.mesh import entry_device, mesh_size


def resolve_fused_mode(model, fused: str, n_chains, device) -> str:
    """Resolve ``fused="auto"`` to ``"cl"``, ``"clx"`` or ``"never"`` by the
    shared gate (:func:`twoforone_torch.ops.fused_score_clx.auto_fused_path`);
    explicit values pass through untouched."""
    if fused != "auto":
        return fused
    from twoforone_torch.ops.fused_score_clx import auto_fused_path

    path = auto_fused_path(model, n_chains, device)
    return "never" if path == "plain" else path


def make_diffusion_force_fn(diffusion, params, t: int, kbt_inv: float,
                            fused: str = "never", n_chains: Optional[int] = None,
                            device="cuda", mesh=None, bf16: bool = False):
    """Build ``x -> (potential, forces)`` from a diffusion model at noise level t.

    ``params`` is the flax parameter tree (nested dict of numpy arrays, see
    :func:`twoforone_torch.utils.artifacts.load_ema_params`). ``x`` is in
    *normalized* units (divided by norm_factor). The potential returned is
    zeros. ``n_chains`` is the number of parallel chains the function will
    be called with; ``fused="auto"`` reads it. The returned function carries
    the force scale as ``.scale`` and the resolved path as ``.mode``.

    ``mesh``: the chains are split over its ranks, and each rank calls the
    function on its own ``n_chains // size`` chains, which is the count the
    ``"auto"`` gate sees (1024 chains over 8 ranks is 128 a rank: the plain
    network where one device would take ``"clx"``).

    ``fused="always"`` runs any conservative model, whatever its edge
    configuration, through one kernel launch per call. The JAX function's
    ``fused_block`` is a TPU tiling argument (chains per grid step, with the
    chains padded to a multiple of it) and is left out: the kernel takes any
    number of chains.

    ``bf16`` runs the plain network (``"never"``) in bfloat16 on its float32
    weights. The kernels of ``"cl"``, ``"clx"`` and ``"always"`` compute in
    float32 and ignore it, as the JAX package's fused paths do: the same
    bits as ``bf16=False``. The ``"auto"`` gate reads the float32 model.
    """
    device = entry_device(device, mesh)
    buf = diffusion.buffers
    # Read from the float32 buffer, as the JAX driver does.
    sqrt_one_minus = float(buf.sqrt_one_minus_alphas_cumprod[t])
    t_norm = float(t) / diffusion.timesteps
    scale = 1.0 / (kbt_inv * sqrt_one_minus)
    model = diffusion.model
    chains_per_rank = None if n_chains is None else n_chains // mesh_size(mesh)
    mode = resolve_fused_mode(model, fused, chains_per_rank, device)

    if mode == "cl":
        from twoforone_torch.ops.fused_score_cl import augment_params_cl, fused_force_cl

        folded = augment_params_cl(model, params, device)

        def eps_fn(x):
            return fused_force_cl(x, t_norm, folded)
    elif mode == "clx":
        from twoforone_torch.ops.fused_score_clx import make_clx_force_fn

        # Eager: on the card the evaluation runs inside the simulation's
        # captured step, where an evaluation graph of its own cannot be made.
        eps_fn = make_clx_force_fn(model, params, t_norm, device, graphed=False)
    elif mode == "never":
        score_fn = diffusion.score_fn(params, device, bf16=bf16)

        def eps_fn(x):
            tt = torch.full((x.shape[0],), t_norm, dtype=torch.float32, device=x.device)
            return score_fn(x, tt)
    elif mode == "always":
        from twoforone_torch.ops.fused_score import make_fused_force_kernel

        eps_fn = make_fused_force_kernel(model, params, t_norm, device)
    else:
        raise ValueError(f"unknown fused mode {fused!r} (auto, cl, clx, always, never)")

    def force_fn(x):
        forces = -eps_fn(x) * scale
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device), forces

    force_fn.scale = scale
    force_fn.mode = mode
    return force_fn


class LangevinDiffusion:
    """Simulate Langevin dynamics from a trained diffusion model.

    Normalizes the initial coordinates, converts the score into forces with
    consistent units, auto-derives dt when not given, runs BAOA(F)B on
    ``device``, and rescales the saved trajectory back to data units.
    ``fused`` defaults to the plain network (``"never"``), as in the JAX
    package, so the same call runs the same path in both; ``"auto"`` and the
    kernels are asked for explicitly. ``bf16`` (default ``False``, as in the
    JAX package) runs the plain network's force in bfloat16; the fused paths
    ignore it (:func:`make_diffusion_force_fn`).

    ``mesh`` shards the chains over its ranks (their count must be a
    multiple of its size); :meth:`sample` returns all chains on every rank.
    """

    def __init__(
        self,
        diffusion,
        params,
        init_mol,
        n_timesteps: int = 1000000,
        save_interval: int = 250,
        t: int = 15,
        temp_data: float = 300,
        temp_sim: float = 300,
        dt: Optional[float] = 2e-3,
        masses: Sequence[float] = (12.8,) * 5,
        friction: Optional[float] = 1,
        kb: str = "consistent",
        random_seed: Optional[int] = None,
        steps_per_chunk: Optional[int] = None,
        log: bool = True,
        fused: str = "never",
        bf16: bool = False,
        restraint_k: float = 0.0,
        max_force: Optional[float] = None,
        dt_scale: float = 1.0,
        device="cuda",
        mesh=None,
    ):
        device = entry_device(device, mesh)
        self.norm_factor = float(diffusion.norm_factor)
        init_sample = np.asarray(init_mol, dtype=np.float32) / self.norm_factor
        buf = diffusion.buffers
        self.one_minus_alphas_cumprod = 1.0 - float(buf.alphas_cumprod[t])

        if kb == "consistent":
            self.kb_inv = 1.0 / KB * self.norm_factor**2
        elif kb == "kcal":
            self.kb_inv = JPERKCAL / KBOLTZMANN / AVOGADRO * (self.norm_factor**2) / 100
        else:
            raise ValueError("Wrong kb value")

        self.force_fn = make_diffusion_force_fn(
            diffusion, params, t, kbt_inv=self.kb_inv / temp_data,
            fused=fused, n_chains=init_sample.shape[0], device=device, mesh=mesh, bf16=bf16,
        )

        if friction is None:
            friction_aux = 1.0
            diffusion_constant = 1.0 / masses[0]
        else:
            friction_aux = friction
            diffusion_constant = 1.0
        if dt is None:
            # Auto-dt from the noise floor:
            # dt = (1 - alpha_bar_t) * gamma * m * kb_inv / T_data
            dt = (
                self.one_minus_alphas_cumprod * friction_aux * masses[0]
                * self.kb_inv / temp_data
            )
        # dt_scale < 1 trades wall-clock for lower O(dt^2) stationary bias.
        dt = dt * dt_scale

        self.sim = LangevinSimulation(
            force_fn=self.force_fn,
            initial_coordinates=init_sample,
            length=n_timesteps,
            save_interval=save_interval,
            beta=self.kb_inv / temp_sim,
            save_potential=False,
            log_interval=save_interval if log else None,
            log_type="print",
            diffusion=diffusion_constant,
            masses=list(masses),
            friction=friction,
            dt=dt,
            random_seed=random_seed,
            steps_per_chunk=steps_per_chunk,
            restraint_k=restraint_k,
            max_force=max_force,
            device=device,
            mesh=mesh,
        )

        if log:
            fr = 1.0 if friction is None else friction
            print(f"norm factor:{self.norm_factor}")
            print(f"Diffusion model Beta : {float(buf.betas[t])}")
            print(f"Diffusion model sqrt_alphas_cumprod {float(buf.sqrt_alphas_cumprod[t])}")
            print(
                "Diffusion model sqrt_one_minus_alphas_cumprod "
                f"{float(buf.sqrt_one_minus_alphas_cumprod[t])}"
            )
            print(f"Diffusion model one_minus_alphas_cumprod {self.one_minus_alphas_cumprod}")
            print(
                f"dt*kb*T/M/gamma: {dt * temp_data / self.kb_inv / masses[0] / fr} "
                "(should be on a similar scale as one_minus_alphas_cumprod)"
            )
            print(f"dt: {dt: .8f} (ps)")
            print(f"KbT: {temp_data / self.kb_inv: .4f}")

    def sample(self, reference_temp: Optional[float] = None) -> np.ndarray:
        """Run the simulation; return (n_frames_total, n_beads, 3) in Angstrom
        (all chains concatenated, chains-major, on every rank of a mesh).
        ``reference_temp`` (K) enables the
        integrator's tempering ramp."""
        reference_beta = (
            None if reference_temp is None else self.kb_inv / float(reference_temp)
        )
        traj = self.sim.simulate(reference_beta=reference_beta)
        traj = traj.reshape(-1, traj.shape[2], traj.shape[3])
        return traj * self.norm_factor
