"""The numbers a check compares."""

from __future__ import annotations

import math

import torch


def gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest difference of ``got`` from ``ref``, over the widest entry
    of ``ref`` (NaN where ``got`` holds a non-finite number)."""
    if not bool(torch.isfinite(got).all()):
        return math.nan
    return float((got - ref).abs().max() / ref.abs().max())


def chain_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each chain's (leading axis) widest difference of ``got`` from
    ``ref``, over the widest entry of ``ref`` (all NaN where ``got`` holds a
    non-finite number)."""
    per_chain = (got - ref).abs().flatten(1).amax(1) / ref.abs().max()
    return per_chain if bool(torch.isfinite(got).all()) else torch.full_like(per_chain, math.nan)


def upper_quartile(gaps: torch.Tensor) -> float:
    return float(torch.quantile(gaps.double(), 0.75))


def count_over(gaps: torch.Tensor, threshold: float) -> float:
    """How many of ``gaps`` pass ``threshold`` (NaN where any is NaN)."""
    return math.nan if bool(gaps.isnan().any()) else float((gaps > threshold).sum())


def widest(gaps) -> float:
    """The largest of ``gaps``, NaN where any is NaN."""
    gaps = list(gaps)
    return math.nan if any(math.isnan(g) for g in gaps) else max(gaps)
