"""Plain PyTorch reference of the diffusion-model force field driving
underdamped Langevin dynamics (BAOA(F)B), independent of the program.

Units as in Arts et al. (JCTC 2023) and the upstream ``sampling``: Angstrom,
ps, K, g/mol; coordinates divided by the norm factor. With ``KB`` in
(g/mol) A^2 ps^-2 K^-1, ``kb_inv = nf^2 / KB``, ``beta = kb_inv / T_sim``,
and the force at noise level t is ``F = -eps_hat(x, t/T) / (kb_inv / T_data
/ sqrt(1 - abar_t))``, clamped per component to +-``max_force``, with the
harmonic tether ``-restraint_k x``. One step, on the centred coordinates:

    v += dt F / m;  x += v dt/2;
    v = v e^{-gamma dt} + sqrt(1 - e^{-2 gamma dt}) sqrt(1/(beta m)) z;  x += v dt/2

with ``z`` the step's standard-normal draw of shape (chains, beads, 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .network import center, cosine_alphas_cumprod, eps_hat

KB = 0.83144626181  # Boltzmann's constant in (g/mol) A^2 ps^-2 K^-1


def constants(config: dict, dt: float, mass: float, friction: float) -> dict:
    """The step's numbers for a configuration (``norm_factor``,
    ``temperature``, ``langevin_t``, ``timesteps``), in float64 on the host."""
    nf = config["norm_factor"]
    kb_inv = nf**2 / KB
    beta = kb_inv / config["temperature"]
    abar = cosine_alphas_cumprod(config["timesteps"])[config["langevin_t"]]
    sqrt_one_minus = float(np.float32(np.sqrt(1.0 - abar)))  # the float32 schedule buffer
    vscale = math.exp(-dt * friction)
    return dict(scale=1.0 / (beta * sqrt_one_minus),
                t_norm=config["langevin_t"] / config["timesteps"], beta=beta, dt=dt, mass=mass,
                vscale=vscale, noisescale=math.sqrt(1.0 - vscale * vscale))


def skip_draws(generator: torch.Generator, shape, count: int) -> None:
    """Advance ``generator`` past ``count`` draws of ``shape``."""
    for _ in range(count):
        torch.randn(shape, generator=generator, device=generator.device)


def run(params, x, v, steps: int, generator: torch.Generator, c: dict, max_force: float,
        restraint_k: float):
    """``steps`` BAOA(F)B steps from (x, v), the noise drawn from
    ``generator``; returns the final (x, v)."""
    noise_coef = c["noisescale"] * math.sqrt(1.0 / (c["beta"] * c["mass"]))
    for _ in range(steps):
        x = center(x)
        forces = -eps_hat(params, x, c["t_norm"]) * c["scale"]
        forces = forces.clamp(-max_force, max_force) - restraint_k * x
        z = torch.randn(x.shape, generator=generator, device=x.device)
        v = v + c["dt"] * forces / c["mass"]
        x = x + v * (c["dt"] / 2.0)
        v = v * c["vscale"] + noise_coef * z
        x = x + v * (c["dt"] / 2.0)
    return x, v
