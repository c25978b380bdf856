"""Scalar evaluation metrics: JS/KL divergences, free-energy MSE, torsions
(copy of ``twoforone_tpu/evaluate/metrics.py`` over the port's geometry).

The definitions are the reference's, so scores stay comparable with the
golden references: histograms are normalized and offset by 1e-10 before
the JS divergence; the kBT constant is at 300 K in kcal/mol.
"""

from __future__ import annotations

import numpy as np
import torch

from twoforone_torch.ops.geometry import dihedrals

# kB*T at 300K in kcal/mol
K_B = 1.380650324e-23  # J/K
T = 300  # K
PER_MOL = 6.02214076e23  # /mol
J_PER_CAL = 4.184  # J/cal
K_BT_IN_KCAL_PER_MOL = K_B * T * PER_MOL / 1000 / J_PER_CAL


def normalize_histogram(hist) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    return hist / np.sum(hist)


def kl_divergence(p1: np.ndarray, p2: np.ndarray) -> float:
    return float(np.sum(p1 * np.log(p1 / p2)))


def js_divergence(h1, h2) -> float:
    """Jensen-Shannon divergence between two (possibly unnormalized) histograms."""
    p1 = normalize_histogram(h1) + 1e-10
    p2 = normalize_histogram(h2) + 1e-10
    m = (p1 + p2) / 2
    return (kl_divergence(p1, m) + kl_divergence(p2, m)) / 2


def free_energy_mse(density1, density2) -> float:
    """MSE of free energies between two discrete probability distributions;
    infinite cells are masked out."""
    with np.errstate(divide="ignore"):
        u1 = K_BT_IN_KCAL_PER_MOL * np.log(np.asarray(density1, dtype=np.float64))
        u2 = K_BT_IN_KCAL_PER_MOL * np.log(np.asarray(density2, dtype=np.float64))
    u1 = np.where(np.isinf(u1), np.nan, u1)
    u2 = np.where(np.isinf(u2), np.nan, u2)
    count = np.sum(np.isfinite(u1 - u2))
    return float(np.nansum(np.square(u1 - u2)) / count)


def kl_div_density(density1, density2) -> float:
    """KL between discrete densities with zero-cell handling."""
    density1 = np.asarray(density1, dtype=np.float64)
    density2 = np.asarray(density2, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = density2 / density1
    ratio[density1 == 0] = 1
    ratio[density2 == 0] = 1
    return float(-np.nansum(density1 * np.log(ratio)))


ALA2_TORSION_INDICES = [[0, 1, 2, 3], [1, 2, 3, 4]]


def get_torsions(coords) -> np.ndarray:
    """phi/psi torsions of the 5-bead ala2 CG model. coords: (B, 5, 3) -> (B, 2),
    computed in float32."""
    x = torch.as_tensor(np.asarray(coords, dtype=np.float32))
    return dihedrals(x, ALA2_TORSION_INDICES).numpy()


def get_prob(tors_data, n_bins: int = 61) -> np.ndarray:
    """Normalized 2D histogram over phi-psi space."""
    bin_edges = np.linspace(-np.pi, np.pi, n_bins)
    hist, _, _ = np.histogram2d(
        tors_data[:, 0], tors_data[:, 1], bins=bin_edges, density=True
    )
    return hist / hist.sum()


def histogram2d_normed(x, y, bins):
    """np.histogram2d with density normalization (the reference's
    ``normed=True``, a keyword numpy >= 1.24 no longer has)."""
    return np.histogram2d(x, y, bins=bins, density=True)
