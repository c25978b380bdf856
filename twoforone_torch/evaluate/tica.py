"""Time-lagged independent component analysis (TICA), deeptime-compatible
(copy of ``twoforone_tpu/evaluate/tica.py``).

- :class:`TicaProjection`: the transform ``(x - mean_0) @ coeffs[:, :dim]``;
- :func:`fit_tica`: a fit that reproduces deeptime's estimator for the
  configuration the reference uses (symmetrized covariances, no Bessel
  correction, kinetic-map scaling);
- :mod:`twoforone_torch.evaluate.deeptime_compat` loads the golden pickles
  without deeptime installed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TicaProjection:
    """Linear TICA transform: whitened projection onto the slowest modes."""

    mean: np.ndarray  # (F,)
    coefficients: np.ndarray  # (F, F) instantaneous coefficients
    singular_values: np.ndarray  # (F,)
    dim: int = 2

    def __call__(self, features: np.ndarray) -> np.ndarray:
        return self.transform(features)

    def transform(self, features: np.ndarray) -> np.ndarray:
        features = np.asarray(features, dtype=np.float64)
        return (features - self.mean) @ self.coefficients[:, : self.dim]


def fit_tica(
    features: np.ndarray,
    lagtime: int = 100,
    dim: int = 2,
    epsilon: float = 1e-6,
    scaling: str = "kinetic_map",
) -> TicaProjection:
    """Fit TICA with deeptime's conventions (symmetrized, bessel=False).

    ``features``: (n_frames, F) time-ordered feature trajectory.
    """
    x = np.asarray(features, dtype=np.float64)
    x0, xt = x[:-lagtime], x[lagtime:]
    n = x0.shape[0]

    # Symmetrized estimation: C00 == Ctt, C0t symmetric.
    mean = (x0.mean(axis=0) + xt.mean(axis=0)) / 2.0
    a = x0 - mean
    b = xt - mean
    c00 = (a.T @ a + b.T @ b) / (2.0 * n)
    c0t = (a.T @ b + b.T @ a) / (2.0 * n)

    # Whiten by C00^{-1/2} (rank-truncated at epsilon), SVD of the whitened
    # cross-covariance; kinetic_map scales projections by singular values.
    evals, evecs = np.linalg.eigh(c00)
    mask = evals > epsilon
    l0 = evecs[:, mask] * (evals[mask] ** -0.5)[None, :]
    k = l0.T @ c0t @ l0
    u, s, _ = np.linalg.svd(k)
    coeffs = l0 @ u
    if scaling == "kinetic_map":
        coeffs = coeffs * s[None, :]
    elif scaling is not None:
        raise ValueError(f"unknown scaling {scaling}")
    return TicaProjection(mean=mean, coefficients=coeffs, singular_values=s, dim=dim)
