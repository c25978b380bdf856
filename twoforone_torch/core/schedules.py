"""Diffusion schedules and derived buffers (port of ``core/schedules.py``).

Built in float64 with numpy, then frozen into float32 tensors, exactly as the
JAX package does: coefficients read back as Python floats (the Langevin
force scale) round through the same float32 values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear beta schedule, float64."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol–Dhariwal cosine schedule, float64."""
    steps = timesteps + 1
    x = np.linspace(0.0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1.0 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


class DiffusionBuffers(NamedTuple):
    """All per-timestep coefficients; each a ``(T,)`` float32 CPU tensor."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weights: torch.Tensor  # timestep-sampling weights ("p2_loss_weight")

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionBuffers":
        """The buffers on ``device``; a sampling loop moves them once instead
        of at every :func:`extract`."""
        return DiffusionBuffers(*(b.to(device) for b in self))


def make_loss_weights(name: str, betas: np.ndarray) -> np.ndarray:
    """Timestep-importance weights (``ones``, ``score_matching``,
    ``higheruntil_K``, ``lower_bound_K``), float64."""
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    T = len(alphas_cumprod)
    if name == "ones":
        w = np.ones(T, dtype=np.float64)
    elif name == "score_matching":
        w = 1.0 / (1.0 - alphas_cumprod)
    elif name.startswith("higheruntil_"):
        threshold = int(name.split("_")[1])
        w1 = T / threshold
        w2 = T / (T - threshold)
        w = np.array([w1] * threshold + [w2] * (T - threshold), dtype=np.float64)
    elif name.startswith("lower_bound"):
        clamp_val = int(name.split("_")[2])
        unnormalized = np.clip(1.0 / ((1.0 - alphas_cumprod) * (1.0 - betas)), 0, clamp_val)
        w = unnormalized / unnormalized.sum() * T
    else:
        raise ValueError(f"Wrong loss_weights: {name}")
    return w


def make_buffers(
    timesteps: int = 1000,
    beta_schedule: str = "cosine",
    loss_weights: str = "ones",
) -> DiffusionBuffers:
    """Build all diffusion buffers in float64 and freeze to float32 tensors."""
    if beta_schedule == "linear":
        betas = linear_beta_schedule(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    return DiffusionBuffers(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        loss_weights=f32(make_loss_weights(loss_weights, betas)),
    )


def extract(buf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped for (B, N, 3) broadcasting."""
    return buf.to(t.device)[t][:, None, None]
