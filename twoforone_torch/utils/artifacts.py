"""Staged trained-control artifacts (``twoforone_tpu/assets/trained/<name>/``).

The port reads the JAX package's staged files by path (data access, not an
import): ``model-best.msgpack`` holds
``{step, params, ema_params, opt_state, best_val_loss}`` in flax's msgpack
format, ``config.json`` the training config and ``results.json`` the
physics scores that gated the staging.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from twoforone_torch.data.molecules import ASSETS_DIR
from twoforone_torch.utils.checkpoint import read_checkpoint

_TRAINED = os.path.join(ASSETS_DIR, "trained")


def trained_dir(name: str) -> str:
    """Directory of the staged artifact ``name`` (e.g. ``chain10``)."""
    return os.path.join(_TRAINED, name)


def is_staged(name: str) -> bool:
    return os.path.exists(os.path.join(trained_dir(name), "model-best.msgpack"))


def load_results(name: str) -> Optional[dict]:
    """The physics scores that gated the staging, or None when unstaged."""
    path = os.path.join(trained_dir(name), "results.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_ema_params(name: str) -> dict:
    """EMA weights of a staged artifact as a nested dict of numpy arrays
    (the flax parameter tree). Raises FileNotFoundError when unstaged."""
    path = os.path.join(trained_dir(name), "model-best.msgpack")
    return read_checkpoint(path)["ema_params"]
