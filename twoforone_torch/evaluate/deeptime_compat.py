"""Unpickle files that name classes this environment lacks (copy of the
unpickler in ``twoforone_tpu/evaluate/deeptime_compat.py``).

A legacy ``args.pickle`` holds an argparse Namespace that may carry objects
of packages that are not installed (a torch activation, deeptime
estimators). The unpickler stands an attribute bag in for every class it
cannot import, so the plain values can still be read.
"""

from __future__ import annotations

import pickle
from typing import Any


class _Duck:
    """Attribute bag standing in for any unimportable class."""

    def __init__(self, *args, **kwargs):
        self._init_args = args
        self._init_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class DuckUnpickler(pickle.Unpickler):
    """Unpickler that substitutes attribute bags for missing classes."""

    def find_class(self, module: str, name: str):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (_Duck,), {"_module": module})


def duck_load(path: str) -> Any:
    with open(path, "rb") as f:
        return DuckUnpickler(f).load()
