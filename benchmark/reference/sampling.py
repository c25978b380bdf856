"""Plain PyTorch references of the two samplers over the cosine schedule.

Deterministic DDIM (eta = 0; Song et al. 2020, eq. 12), with the guards of
the upstream sampler: centre of mass kept at zero, x0 clamped to +-10 and eps
recomputed from it, the state clamped to +-1000 after each step. The ladder:
``sample_steps`` timesteps rounded from an even spacing of [T-1, 0]; the last
step hops to x0.

The full ancestral chain (upstream ``p_sample_loop``): see :func:`ancestral`.

Samples come back in data units (times the norm factor).
"""

from __future__ import annotations

import numpy as np
import torch

from .network import center, cosine_alphas_cumprod, cosine_betas, eps_hat


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


def ancestral(params, x_init, draws, config: dict) -> torch.Tensor:
    """The full ancestral chain (T score calls) from the standard-normal
    ``x_init`` (B, N, 3), upstream ``p_sample`` at every t from T-1 down to
    0: the x0 estimate ``sqrt(1/abar_t) x - sqrt(1/abar_t - 1) eps``, the
    posterior mean ``coef1 x0 + coef2 x`` of q(x_{t-1} | x_t, x0), and
    ``exp(0.5 log var)`` times the step's noise with the posterior's log
    variance clipped at 1e-20, multiplied by 0 at t=0. ``draws()`` gives each
    step's standard-normal noise of ``x_init``'s shape, called once a step
    in that order (the caller draws ``x_init`` and then the steps' noise
    from one generator a batch, as the program does).

    Where this departs from upstream, it follows the program's contract:
    eps, the x0 estimate and the noise are centred (zero centre of mass),
    x0 is not clamped (unlike DDIM's guard), and after each step the state
    is clamped to +-1000 and centred; the log variance is clipped at 1e-20
    (upstream puts t=1's in t=0's place, which the mask at t=0 hides); the
    schedule's coefficients are float64 rounded once to float32, as the
    program's buffers are; the noise comes from the batch's own generator
    in the order above, not from a global one."""
    T = config["timesteps"]
    betas = cosine_betas(T)
    abar = np.cumprod(1.0 - betas)
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    var = betas * (1.0 - abar_prev) / (1.0 - abar)
    f32 = lambda a: float(np.float32(a))  # noqa: E731  the float32 schedule buffers
    x = center(x_init)
    for t in range(T - 1, -1, -1):
        eps = center(eps_hat(params, x, float(np.float32(t) / np.float32(T))))
        x0 = center(f32(np.sqrt(1.0 / abar[t])) * x - f32(np.sqrt(1.0 / abar[t] - 1.0)) * eps)
        mean = (f32(betas[t] * np.sqrt(abar_prev[t]) / (1.0 - abar[t])) * x0
                + f32((1.0 - abar_prev[t]) * np.sqrt(1.0 - betas[t]) / (1.0 - abar[t])) * x)
        z = center(draws())
        log_var = np.float32(np.log(max(var[t], 1e-20)))
        x = mean + (0.0 if t == 0 else f32(np.exp(0.5 * np.float64(log_var)))) * z
        x = center(x.clamp(-1000.0, 1000.0))
    return x * config["norm_factor"]
