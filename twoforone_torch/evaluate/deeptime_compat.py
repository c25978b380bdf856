"""Unpickle files that name classes this environment lacks (copy of
``twoforone_tpu/evaluate/deeptime_compat.py``).

A legacy ``args.pickle`` holds an argparse Namespace that may carry objects
of packages that are not installed (a torch activation, deeptime
estimators), and the golden TICA references
(``assets/saved_references/saved_TICA_*.pickle``) embed fitted
``deeptime.decomposition.TICA`` estimators. The unpickler stands an
attribute bag in for every class it cannot import, so the plain values can
still be read; the TICA loader extracts the linear transform
(``transform(x) == (x - cov.mean_0) @ instantaneous_coefficients[:, :dim]``).
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

from twoforone_torch.evaluate.tica import TicaProjection


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


def tica_projection_from_estimator(est: Any) -> TicaProjection:
    """Extract the linear TICA transform from a (duck-loaded) deeptime TICA."""
    model = est._model if hasattr(est, "_model") else est
    cov = model._cov
    mean = np.asarray(cov._mean_0, dtype=np.float64)
    coeffs = np.asarray(model._instantaneous_coefficients, dtype=np.float64)
    svals = np.asarray(model._singular_values, dtype=np.float64)
    dim = int(model._dim)
    return TicaProjection(mean=mean, coefficients=coeffs, singular_values=svals, dim=dim)


def load_tica_reference(path: str):
    """Load a saved_TICA_*.pickle -> (TicaProjection, gt_prob, bin_edges_x, bin_edges_y)."""
    tica_est, gt_prob, bin_edges_x, bin_edges_y = duck_load(path)
    return (
        tica_projection_from_estimator(tica_est),
        np.asarray(gt_prob),
        np.asarray(bin_edges_x),
        np.asarray(bin_edges_y),
    )


def _to_numpy(x):
    """Convert the torch tensors inside the golden pickles to numpy."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_pwd_reference(path: str):
    """Load a saved_pwd_*.pickle -> (gt_max (P,), gt_hist list of (bins_i,))."""
    data = duck_load(path)
    gt_max = _to_numpy(data["gt_max"]).astype(np.float64)
    gt_hist = [_to_numpy(h).astype(np.float64) for h in data["gt_hist"]]
    return gt_max, gt_hist
