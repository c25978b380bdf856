"""Ergodicity / basin-exchange analysis of Langevin trajectories (port of
``twoforone_tpu/evaluate/ergodicity.py``, numpy over the port's float32
dihedrals).

The physics bars of the controls (:mod:`twoforone_torch.train.positive_control`)
hold the stationary distribution of a Langevin run to the generator's
(TIC JS, dihedral JS). That metric cannot see chains frozen in their
starting basin: the chains start from the model's own i.i.d. samples, so a
force field with impassable barriers still gives a right stationary
histogram. What tells a working force field from a frozen one is basin
exchange: single chains must cross between metastable states during the run.

For the synthetic control systems the metastable states are known exactly:
the multi-modal (slow) torsions of the von Mises mixture generator
(:mod:`twoforone_torch.data.synthetic`). Each saved frame's slow torsions are
assigned to their mixture basin by maximum responsibility, and per slow
torsion the report gives:

- ``hop_fraction``: fraction of chains that crossed basins at least once,
- ``hops_per_frame``: pooled label-switch rate over saved frames,
- ``occupancy_error``: |pooled basin-0 occupancy - generator weight|.

No kinetic parity is asserted: diffusion-model force fields reproduce
thermodynamics, not timescales. Ergodicity (hop_fraction > 0 on every slow
mode) is the necessary condition.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from twoforone_torch.ops.geometry import dihedrals, sliding_dihedral_indices


def basin_labels(
    theta: np.ndarray, components: Sequence[Tuple[float, float, float]]
) -> np.ndarray:
    """Maximum-responsibility mixture-component assignment.

    ``theta``: angles (any shape, radians); ``components``: the generator's
    (weight, mean, concentration) von Mises components for ONE torsion.
    Returns int labels of the same shape.
    """
    from scipy.special import i0

    theta = np.asarray(theta, dtype=np.float64)
    dens = np.stack(
        [
            w * np.exp(kappa * np.cos(theta - mu)) / (2 * np.pi * i0(kappa))
            for (w, mu, kappa) in components
        ],
        axis=-1,
    )
    return np.argmax(dens, axis=-1)


def hop_statistics(labels: np.ndarray) -> dict:
    """Per-chain basin-exchange statistics.

    ``labels``: (n_chains, n_frames) int basin labels along each chain.
    """
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(f"labels must be (n_chains, n_frames), got {labels.shape}")
    switches = labels[:, 1:] != labels[:, :-1]  # (chains, frames-1)
    hops_per_chain = switches.sum(axis=1)
    return {
        "hop_fraction": float((hops_per_chain > 0).mean()),
        "hops_per_frame": float(switches.mean()) if switches.size else 0.0,
        "median_hops_per_chain": float(np.median(hops_per_chain)),
    }


def slow_torsion_ergodicity(
    traj_chains: np.ndarray,
    components,
    min_hop_fraction: float = 0.0,
) -> dict:
    """Basin-exchange report for every slow (multi-modal) torsion.

    ``traj_chains``: (n_chains, n_frames, n_beads, 3) Langevin trajectory in
    Angstrom, chain-major as the control runs save it (the flat output of
    ``LangevinDiffusion.sample``, un-flattened).
    ``components``: the generator's per-torsion mixture components
    (:mod:`twoforone_torch.data.synthetic`: torsion k is the dihedral over
    beads k..k+3, mdtraj's sign).

    Returns ``{"per_torsion": {k: {...}}, "min_hop_fraction": float,
    "max_occupancy_error": float, "ergodic": bool}`` where ``ergodic``
    means every slow torsion's hop_fraction exceeds ``min_hop_fraction``.
    """
    traj_chains = np.asarray(traj_chains)
    if traj_chains.ndim != 4:
        raise ValueError(
            f"traj_chains must be (chains, frames, beads, 3), got {traj_chains.shape}"
        )
    n_chains, n_frames, n_beads = traj_chains.shape[:3]
    ind = sliding_dihedral_indices(n_beads)
    flat = traj_chains.reshape(n_chains * n_frames, n_beads, 3)
    # (chains*frames, n_torsions) in one vectorized call, then chain-major
    theta = dihedrals(torch.as_tensor(flat, dtype=torch.float32), ind).numpy()
    theta = theta.reshape(n_chains, n_frames, -1)

    per_torsion = {}
    for k, comps in enumerate(components):
        if len(comps) < 2:
            continue  # unimodal fast mode: no basins to exchange
        labels = basin_labels(theta[:, :, k], comps)
        stats = hop_statistics(labels)
        w0 = comps[0][0] / sum(c[0] for c in comps)
        stats["occupancy_error"] = float(abs((labels == 0).mean() - w0))
        per_torsion[k] = stats

    if not per_torsion:
        return {"per_torsion": {}, "ergodic": True,
                "min_hop_fraction": 1.0, "max_occupancy_error": 0.0}
    min_hop = min(s["hop_fraction"] for s in per_torsion.values())
    max_occ = max(s["occupancy_error"] for s in per_torsion.values())
    return {
        "per_torsion": per_torsion,
        "min_hop_fraction": min_hop,
        "max_occupancy_error": max_occ,
        "ergodic": bool(min_hop > min_hop_fraction),
    }
