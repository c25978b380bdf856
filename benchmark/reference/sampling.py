"""Plain PyTorch reference of deterministic DDIM sampling (eta = 0; Song et
al. 2020, eq. 12) over the cosine schedule, with the guards of the upstream
sampler: centre of mass kept at zero, x0 clamped to +-10 and eps recomputed
from it, the state clamped to +-1000 after each step.

The ladder: ``sample_steps`` timesteps rounded from an even spacing of
[T-1, 0]; the last step hops to x0. Samples come back in data units (times
the norm factor).
"""

from __future__ import annotations

import numpy as np
import torch

from .network import center, cosine_alphas_cumprod, eps_hat


def ladder(timesteps: int, sample_steps: int) -> list:
    taus = np.unique(np.round(np.linspace(timesteps - 1, 0, sample_steps)).astype(np.int64))[::-1]
    return list(zip(taus.tolist(), [*taus[1:].tolist(), -1]))


def ddim(params, x_init, config: dict, sample_steps: int) -> torch.Tensor:
    """DDIM from the standard-normal ``x_init`` (B, N, 3)."""
    T = config["timesteps"]
    abar64 = cosine_alphas_cumprod(T)
    f32 = lambda a: float(np.float32(a))  # noqa: E731  the float32 schedule buffers
    x = center(x_init)
    for tau, prev in ladder(T, sample_steps):
        eps = center(eps_hat(params, x, float(np.float32(tau) / np.float32(T))))
        abar_t = f32(abar64[tau])
        x0 = center(f32(np.sqrt(1.0 / abar64[tau])) * x
                    - f32(np.sqrt(1.0 / abar64[tau] - 1.0)) * eps)
        x0 = center(x0.clamp(-10.0, 10.0))
        eps = (x - abar_t**0.5 * x0) / (1.0 - abar_t) ** 0.5
        abar_prev = 1.0 if prev < 0 else f32(abar64[prev])
        x = abar_prev**0.5 * x0 + max(1.0 - abar_prev, 0.0) ** 0.5 * eps
        x = center(x.clamp(-1000.0, 1000.0))
    return x * config["norm_factor"]
