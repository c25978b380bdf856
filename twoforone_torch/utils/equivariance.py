"""Symmetry checkers for score networks (port of
``twoforone_tpu/utils/equivariance.py``).

Each checker draws its inputs from ``generator`` (default: a CPU generator
seeded 0), on the generator's device, evaluates ``score_fn(x, t)`` at
t = 0.5 for every chain, and returns the mean L1 gap, so that a test can
assert it. The same generator seed gives the same inputs, so two score
functions on one device can be held to each other's gaps.
"""

from __future__ import annotations

from typing import Optional

import torch

from twoforone_torch.ops.geometry import random_rotation, rotate


def _draw(generator: Optional[torch.Generator], batch: int, num_beads: int):
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.randn((batch, num_beads, 3), generator=generator, device=generator.device)
    return x, torch.full((batch,), 0.5, device=generator.device), generator


def check_reflection_equivariance(score_fn, num_beads: int,
                                  generator: Optional[torch.Generator] = None,
                                  batch: int = 256):
    """Returns (invariance_gap, equivariance_gap) under x-axis reflection."""
    x_a, t, _ = _draw(generator, batch, num_beads)
    x_b = x_a.clone()
    x_b[:, :, 0] *= -1.0
    out_a = score_fn(x_a, t)
    out_b = score_fn(x_b, t)
    invariance_gap = (out_a - out_b).abs().mean()
    out_b_reflected = out_b.clone()
    out_b_reflected[:, :, 0] *= -1.0
    equivariance_gap = (out_a - out_b_reflected).abs().mean()
    return float(invariance_gap), float(equivariance_gap)


def check_rotation_equivariance(score_fn, num_beads: int,
                                generator: Optional[torch.Generator] = None,
                                batch: int = 256):
    """L1 gap between rotate(f(x)) and f(rotate(x)), one random rotation per
    chain (drawn from ``generator`` after x)."""
    x, t, generator = _draw(generator, batch, num_beads)
    x_rot, rots = random_rotation(x, generator, return_matrices=True)
    out_rot_expected = rotate(score_fn(x, t), rots)
    return float((score_fn(x_rot, t) - out_rot_expected).abs().mean())


def check_translation_invariance(score_fn, num_beads: int,
                                 generator: Optional[torch.Generator] = None,
                                 batch: int = 256, shift: float = 5.0):
    """L1 gap between f(x) and f(x + shift)."""
    x, t, _ = _draw(generator, batch, num_beads)
    return float((score_fn(x, t) - score_fn(x + shift, t)).abs().mean())
