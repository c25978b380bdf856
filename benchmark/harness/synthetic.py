"""Synthetic chain frames: a copy of the generator of
``twoforone_torch/data/synthetic.py`` (its 10-bead system and its chains of
any length), kept here so that the benchmark makes its training data from
the seed without importing the program.

Chains whose internal coordinates are drawn from known distributions:
narrow Gaussians for bonds and angles, von Mises mixtures for the torsions
(some bimodal, the rest unimodal), built by NeRF and given a random
orientation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

BOND_LENGTH = 1.53  # Angstrom-ish; the physics is scale-free
BOND_STD = 0.02
ANGLE = 1.937  # ~111 degrees
ANGLE_STD = 0.04


def sample_torsion_mixture(
    rng: np.random.Generator,
    n: int,
    components: Sequence[Tuple[float, float, float]],
) -> np.ndarray:
    """Draw ``n`` angles from a von Mises mixture; wrapped to [-pi, pi]."""
    weights = np.array([c[0] for c in components], dtype=np.float64)
    weights = weights / weights.sum()
    which = rng.choice(len(components), size=n, p=weights)
    out = np.empty(n, dtype=np.float64)
    for i, (_, mu, kappa) in enumerate(components):
        m = which == i
        out[m] = rng.vonmises(mu, kappa, size=int(m.sum()))
    return out


def _nerf_extend(a, b, c, bond, angle, torsion):
    """Place the next atom D from the three previous (vectorized NeRF).

    D sits at distance ``bond`` from C, with angle(B, C, D) = ``angle`` and
    dihedral(A, B, C, D) = ``torsion`` under the mdtraj sign convention
    (ops/geometry.py:96-104).
    """
    bc = c - b
    bc = bc / np.linalg.norm(bc, axis=-1, keepdims=True)
    ab = b - a
    n = np.cross(ab, bc)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    m = np.cross(n, bc)
    d_local = np.stack(
        [
            -np.cos(angle),
            np.sin(angle) * np.cos(torsion),
            np.sin(angle) * np.sin(torsion),
        ],
        axis=-1,
    )
    frame = np.stack([bc, m, n], axis=-2)  # rows are the local basis
    return c + bond[..., None] * np.einsum("...i,...ij->...j", d_local, frame)


def build_chain_n(bonds: np.ndarray, angles: np.ndarray, torsions: np.ndarray) -> np.ndarray:
    """Internal -> Cartesian for an N-bead chain (generalizes build_chain).

    bonds: (B, N-1), angles: (B, N-2), torsions: (B, N-3) -> (B, N, 3).
    """
    b = bonds.shape[0]
    n = bonds.shape[1] + 1
    p0 = np.zeros((b, 3))
    p1 = p0 + np.stack([bonds[:, 0], np.zeros(b), np.zeros(b)], axis=-1)
    p2 = p1 + bonds[:, 1, None] * np.stack(
        [-np.cos(angles[:, 0]), np.sin(angles[:, 0]), np.zeros(b)], axis=-1
    )
    pts = [p0, p1, p2]
    for i in range(n - 3):
        pts.append(
            _nerf_extend(
                pts[i], pts[i + 1], pts[i + 2],
                bonds[:, i + 2], angles[:, i + 1], torsions[:, i],
            )
        )
    return np.stack(pts, axis=1)


# 10-bead (chignolin-scale) polymer: 7 torsions. The two central torsions
# are bimodal (slow, metastable — what TICA must find); the rest are
# unimodal fast modes. Jointly a 4-state system with known equilibrium.
CHAIN10_TORSION_COMPONENTS: Tuple[Tuple[Tuple[float, float, float], ...], ...] = (
    ((1.0, -1.0, 10.0),),
    ((1.0, 2.2, 10.0),),
    ((0.6, -1.2, 9.0), (0.4, 1.4, 9.0)),   # slow torsion A
    ((1.0, 0.8, 10.0),),
    ((0.55, -2.0, 8.0), (0.45, 0.6, 8.0)),  # slow torsion B
    ((1.0, -2.4, 10.0),),
    ((1.0, 1.6, 10.0),),
)


def make_chain_components(
    n_torsions: int, n_slow: int = 2, seed: int = 11
) -> Tuple[Tuple[Tuple[float, float, float], ...], ...]:
    """Torsion mixture components for an arbitrary-length chain.

    ``n_slow`` evenly spaced interior torsions are bimodal (metastable slow
    modes); the rest are unimodal fast modes with deterministic
    pseudo-random means. A fixed ``seed`` makes the system the same at
    every call."""
    rng = np.random.default_rng(seed)
    slow = set(
        np.linspace(1, n_torsions - 2, n_slow).round().astype(int).tolist()
    ) if n_slow > 0 else set()
    comps = []
    for k in range(n_torsions):
        if k in slow:
            w = float(rng.uniform(0.4, 0.6))
            mu1 = float(rng.uniform(-np.pi, 0.0))
            mu2 = mu1 + float(rng.uniform(2.0, 3.0))
            mu2 = float(np.mod(mu2 + np.pi, 2 * np.pi) - np.pi)
            comps.append(((w, mu1, 8.0), (1.0 - w, mu2, 8.0)))
        else:
            comps.append(((1.0, float(rng.uniform(-np.pi, np.pi)), 10.0),))
    return tuple(comps)


def chain_components(n_beads: int):
    """The torsion components of a configuration's training frames:
    ``CHAIN10_TORSION_COMPONENTS`` at 10 beads, else
    ``make_chain_components(n_beads - 3, 5, 13)``, the system of the
    program's 56-bead (protein G) synthetic data at any length."""
    if n_beads == 10:
        return CHAIN10_TORSION_COMPONENTS
    return make_chain_components(n_beads - 3, 5, 13)


def _chain_frames(rng, torsions: np.ndarray) -> np.ndarray:
    """Coords for given torsions (B, N-3): bonds/angles are fast Gaussian
    modes, random global SO(3) orientation per frame."""
    b, n_torsions = torsions.shape
    n = n_torsions + 3
    bonds = rng.normal(BOND_LENGTH, BOND_STD, size=(b, n - 1))
    angles = rng.normal(ANGLE, ANGLE_STD, size=(b, n - 2))
    coords = build_chain_n(bonds, angles, torsions)
    coords = coords - coords.mean(axis=1, keepdims=True)
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = np.stack(
        [
            np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], -1),
        ],
        axis=-2,
    )
    coords = np.einsum("bij,bnj->bni", rot, coords)
    return coords.astype(np.float32)


def chain_dataset(
    n_samples: int, components, seed: int = 0
) -> np.ndarray:
    """(n_samples, len(components)+3, 3) i.i.d. equilibrium draws."""
    rng = np.random.default_rng(seed)
    torsions = np.stack(
        [sample_torsion_mixture(rng, n_samples, comp) for comp in components],
        axis=-1,
    )
    return _chain_frames(rng, torsions)
