"""Exponential moving average of the weights (port of
``twoforone_tpu/train/ema.py``), as a second module.

ema-pytorch semantics, as the reference trainer uses them
(``EMA(model, beta=ema_decay, update_every=10)`` with the defaults
``update_after_step=100, inv_gamma=1.0, power=2/3``):

- the EMA copies the online weights for the first ``update_after_step``
  update calls,
- afterwards the decay ramps as ``1 - (1 + epoch/inv_gamma)^(-power)``
  clamped to ``beta``,
- updates apply every ``update_every`` calls.

The decay is computed in float32, as the JAX package computes it, on the
host; the update reads it from device scalars (:func:`ema_due` fills them,
:func:`ema_apply` updates), which is how a captured training step takes a
new decay at every replay. Whether a call updates is the host's decision.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.995
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def init_ema(net: nn.Module) -> nn.Module:
    """A copy of ``net`` that holds the averaged weights (no gradients)."""
    ema = copy.deepcopy(net)
    ema.requires_grad_(False)
    return ema.eval()


def current_decay(step: int, cfg: EMAConfig) -> np.float32:
    """Decay used at EMA-update call ``step`` (0-indexed, counts update calls)."""
    epoch = np.float32(max(int(step) - cfg.update_after_step - 1, 0))
    if epoch <= 0:
        return np.float32(0.0)
    value = np.float32(1.0) - (np.float32(1.0) + epoch / np.float32(cfg.inv_gamma)) ** np.float32(
        -cfg.power)
    return np.float32(min(max(value, np.float32(0.0)), np.float32(cfg.beta)))


def ema_scalars(device) -> tuple:
    """The device scalars of an update, ``(decay, 1 - decay)``: 0-d float32
    tensors that :func:`ema_due` fills and :func:`ema_apply` reads."""
    return torch.zeros((), device=device), torch.zeros((), device=device)


def ema_due(step: int, cfg: EMAConfig, scalars) -> bool:
    """Whether EMA-update call ``step`` updates (the host decides: every
    ``update_every`` calls); when it does, its ``decay`` and ``1 - decay``
    (host float32) are filled into ``scalars``."""
    if int(step) % cfg.update_every != 0:
        return False
    decay = current_decay(step, cfg)
    scalars[0].fill_(float(decay))
    scalars[1].fill_(float(np.float32(1.0) - decay))
    return True


@torch.no_grad()
def ema_apply(ema: nn.Module, net: nn.Module, scalars) -> None:
    """The device work of one EMA update: ``ema = decay ema + (1 - decay)
    net`` in place, with the numbers read from ``scalars``, so that a
    training step's CUDA graph records it once for every update."""
    e = [p for p in ema.parameters()]
    p = [q.detach() for q in net.parameters()]
    torch._foreach_mul_(e, scalars[0])
    torch._foreach_add_(e, torch._foreach_mul(p, scalars[1]))


def ema_update(ema: nn.Module, net: nn.Module, step: int, cfg: EMAConfig) -> None:
    """One (possibly skipped) in-place EMA update of ``ema`` towards ``net``;
    ``step`` counts update calls so far."""
    scalars = ema_scalars(next(ema.parameters()).device)
    if ema_due(step, cfg, scalars):
        ema_apply(ema, net, scalars)
