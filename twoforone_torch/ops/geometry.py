"""Molecular geometry ops (port of ``twoforone_tpu/ops/geometry.py``)."""

from __future__ import annotations

import torch


def center_zero(x: torch.Tensor) -> torch.Tensor:
    """Move each molecule's center of geometry to zero.

    ``x``: (..., N, 3); the mean is removed over the bead axis.
    """
    return x - x.mean(dim=-2, keepdim=True)
