"""Staged trained-control artifacts (``twoforone_tpu/assets/trained/<name>/``).

The port reads the JAX package's staged weight files by path (data access,
not an import): ``model-best.msgpack`` holds
``{step, params, ema_params, opt_state, best_val_loss}`` in flax's msgpack
format.
"""

from __future__ import annotations

import os

from twoforone_torch.utils.checkpoint import load_checkpoint

_TRAINED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "twoforone_tpu", "assets", "trained",
)


def trained_dir(name: str) -> str:
    """Directory of the staged artifact ``name`` (e.g. ``chain10``)."""
    return os.path.join(_TRAINED, name)


def load_ema_params(name: str) -> dict:
    """EMA weights of a staged artifact as a nested dict of numpy arrays
    (the flax parameter tree). Raises FileNotFoundError when unstaged."""
    path = os.path.join(trained_dir(name), "model-best.msgpack")
    return load_checkpoint(path)["ema_params"]
