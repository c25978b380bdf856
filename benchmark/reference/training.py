"""Plain PyTorch reference of the diffusion model's training step,
independent of the program.

- The draws of each step from one generator, in the trainer's order: the
  frames' rotations, their timesteps, their noise.
- The loss (Arts et al. 2023; upstream ``p_losses``, objective pred_noise,
  l2): each frame rotated by its draw, centred and divided by the norm
  factor; ``x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) z`` with the centred
  noise ``z``; the loss is the mean of ``(center(eps_hat(x_t, t/T)) - z)^2``,
  with ``eps_hat = -dE/dx`` kept differentiable (a double backward).
- optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the root, weight
  decay on the pre-update weights) at the cosine rate of the update count
  before the update (``optax.cosine_decay_schedule`` to ``min_lr``).
- ema-pytorch's EMA as the upstream trainer uses it (every 10 update calls;
  a copy for the first 100 calls, then the decay ramp ``1 - (1 +
  epoch)^(-2/3)`` clamped to the configured decay).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .network import center, cosine_alphas_cumprod, eps_hat

B1, B2, EPS = 0.9, 0.999, 1e-8
EMA_EVERY, EMA_AFTER, EMA_POWER = 10, 100, 2.0 / 3.0


def learning_rate(train: dict, count: int) -> float:
    decay_steps = train["train_iter"]
    alpha = train["min_lr_cosine_anneal"] / train["learning_rate"]
    c = min(count, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    return train["learning_rate"] * ((1.0 - alpha) * cosine + alpha)


def ema_decay(train: dict, call: int) -> float:
    epoch = max(call - EMA_AFTER - 1, 0)
    if epoch <= 0:
        return 0.0
    return min(max(1.0 - (1.0 + epoch) ** -EMA_POWER, 0.0), train["ema_decay"])


def loss(params, batch, rotation, t, noise, norm_factor: float, timesteps: int,
         keep: slice = slice(None)):
    """The denoising loss of one step's batch and draws (all on one device);
    ``keep`` selects the rows the mean is taken over (all of them, but for a
    planted fault)."""
    abar = cosine_alphas_cumprod(timesteps)
    sqrt_ab = torch.tensor(np.sqrt(abar), dtype=torch.float32, device=batch.device)
    sqrt_1m = torch.tensor(np.sqrt(1.0 - abar), dtype=torch.float32, device=batch.device)
    batch, rotation, t, noise = batch[keep], rotation[keep], t[keep], noise[keep]
    x0 = center(torch.einsum("bij,bnj->bni", rotation, batch)) / norm_factor
    z = center(noise)
    xt = center(sqrt_ab[t][:, None, None] * x0 + sqrt_1m[t][:, None, None] * z)
    out = center(eps_hat(params, xt, t.to(torch.float32) / timesteps, create_graph=True))
    return ((out - z) ** 2).mean()


def rotations(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz Ry Rx from Euler angles (3, B): the augmentation's rotations."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    b = angles.shape[1]
    rx = torch.stack([one, zero, zero, zero, c[0], s[0], zero, -s[0], c[0]], -1).view(b, 3, 3)
    ry = torch.stack([c[1], zero, -s[1], zero, one, zero, s[1], zero, c[1]], -1).view(b, 3, 3)
    rz = torch.stack([c[2], s[2], zero, -s[2], c[2], zero, zero, zero, one], -1).view(b, 3, 3)
    return rz @ ry @ rx


def draw(generator: torch.Generator, batch: int, beads: int, timesteps: int):
    """One step's draws from ``generator``, in the trainer's order: each
    frame's rotation (three Euler angles ~ U(-pi, pi)), its timestep (by the
    loss weights, which are ones: uniform) and its noise."""
    dev = generator.device
    angles = torch.rand((3, batch), generator=generator, device=dev) * (2.0 * math.pi) - math.pi
    t = torch.multinomial(torch.ones(timesteps, device=dev), batch, replacement=True,
                          generator=generator)
    noise = torch.randn((batch, beads, 3), generator=generator, device=dev)
    return rotations(angles), t, noise


def steps(batches, generator: torch.Generator, skip: int, timesteps: int) -> list:
    """``(batch, rotation, t, noise)`` of each of ``batches`` (host arrays),
    its draws taken from ``generator`` after those of ``skip`` earlier steps."""
    dev = generator.device
    b, n = batches[0].shape[:2]
    for _ in range(skip):
        draw(generator, b, n, timesteps)
    return [(torch.tensor(x, device=dev), *draw(generator, b, n, timesteps)) for x in batches]


def follow(start: dict, steps, train: dict, norm_factor: float, timesteps: int,
           keep: slice = slice(None)) -> dict:
    """Train from ``start`` over ``steps`` (a list of ``(batch, rotation, t,
    noise)``). ``start``: ``weights`` and ``ema`` (``{path: tensor}``), the
    update ``count`` before the first step, and Adam's ``mu`` and ``nu``
    (zeros where left out). Returns ``losses``, the ``first`` step's
    gradient, and the ``weights`` and ``ema`` after the last step."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in start["weights"].items()}
    ema = {k: v.detach().clone() for k, v in start["ema"].items()}
    mu = {k: start["mu"][k].clone() if "mu" in start else torch.zeros_like(v)
          for k, v in leaves.items()}
    nu = {k: start["nu"][k].clone() if "nu" in start else torch.zeros_like(v)
          for k, v in leaves.items()}
    losses, first = [], None
    for count, (batch, rotation, t, noise) in enumerate(steps, start["count"]):
        tree = {}
        for path, leaf in leaves.items():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        value = loss(tree, batch, rotation, t, noise, norm_factor, timesteps, keep)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = learning_rate(train, count)
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k]
                mu[k] = B1 * mu[k] + (1.0 - B1) * g
                nu[k] = B2 * nu[k] + (1.0 - B2) * g * g
                u = (mu[k] / (1.0 - B1 ** (count + 1))) / (
                    torch.sqrt(nu[k] / (1.0 - B2 ** (count + 1))) + EPS)
                p -= lr * (u + train["weight_decay"] * p)
            if count % EMA_EVERY == 0:
                d = ema_decay(train, count)
                for k, p in leaves.items():
                    ema[k] = d * ema[k] + (1.0 - d) * p.detach()
    return {"losses": losses, "first": first,
            "weights": {k: v.detach() for k, v in leaves.items()}, "ema": ema}
