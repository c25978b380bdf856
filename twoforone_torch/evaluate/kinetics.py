"""Kinetic analysis in TIC space: clustering + transition-count matrices
(port of ``twoforone_tpu/evaluate/kinetics.py``, numpy, the same numbers).

MiniBatchKMeans in the 2D TIC space (or fixed cluster centers) and lagged
transition-count matrices over the cluster assignments of each trajectory:
deeptime's ``TransitionCountEstimator(count_mode="sliding")``, implemented
directly. scikit-learn is imported only by :func:`kmeans_centers`; where it
is absent, :func:`tic_state_analysis` runs with given ``centers``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def kmeans_centers(tics: np.ndarray, n_clusters: int, seed: int = 0) -> np.ndarray:
    """Fit MiniBatchKMeans on TIC coordinates; returns (n_clusters, d) centers."""
    from sklearn.cluster import MiniBatchKMeans

    km = MiniBatchKMeans(n_clusters=n_clusters, random_state=seed, n_init="auto")
    km.fit(np.asarray(tics, dtype=np.float64))
    return km.cluster_centers_


def assign_clusters(tics: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-center assignment; tics (..., d) -> labels (...,)."""
    tics = np.asarray(tics, dtype=np.float64)
    centers = np.asarray(centers, dtype=np.float64)
    d2 = ((tics[..., None, :] - centers[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=-1)


def transition_count_matrix(
    labels, n_states: int, lagtime: int = 1, sliding: bool = True
) -> np.ndarray:
    """Count transitions i -> j at the given lagtime.

    ``labels``: one 1D trajectory of state indices, or a sequence of them
    (e.g. per independent Langevin chain); counts accumulate over all.
    ``sliding=True`` counts every (t, t+lag) pair (deeptime's default
    "sliding" count mode); otherwise strided non-overlapping pairs.
    """
    if isinstance(labels, np.ndarray) and labels.ndim == 1:
        labels = [labels]
    elif isinstance(labels, np.ndarray) and labels.ndim == 2:
        labels = list(labels)
    counts = np.zeros((n_states, n_states), dtype=np.int64)
    for traj in labels:
        traj = np.asarray(traj, dtype=np.int64)
        if len(traj) <= lagtime:
            continue
        a = traj[:-lagtime] if sliding else traj[: -lagtime : lagtime]
        b = traj[lagtime:] if sliding else traj[lagtime::lagtime][: len(a)]
        np.add.at(counts, (a, b), 1)
    return counts


def transition_probability_matrix(counts: np.ndarray) -> np.ndarray:
    """Row-normalize a count matrix (rows with no counts become uniform-free zeros)."""
    counts = np.asarray(counts, dtype=np.float64)
    row = counts.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(row > 0, counts / row, 0.0)
    return p


def tic_state_analysis(
    tica_projection,
    get_tic_features,
    trajectories: np.ndarray,
    centers: Optional[np.ndarray] = None,
    n_clusters: int = 4,
    lagtime: int = 1,
    seed: int = 0,
):
    """End-to-end notebook workflow: project trajectories to TIC space,
    cluster (or use fixed centers), and count state transitions per chain.

    ``trajectories``: (n_sims, n_frames, n_beads, 3) in Angstrom.
    Returns dict with centers, per-chain labels, counts, and probabilities.
    """
    trajectories = np.asarray(trajectories)
    n_sims, n_frames = trajectories.shape[:2]
    flat = trajectories.reshape(n_sims * n_frames, *trajectories.shape[2:])
    tics = tica_projection(get_tic_features(flat)).reshape(n_sims, n_frames, -1)
    if centers is None:
        centers = kmeans_centers(tics.reshape(-1, tics.shape[-1]), n_clusters, seed)
    labels = assign_clusters(tics, centers)
    counts = transition_count_matrix(labels, len(centers), lagtime)
    return {
        "centers": centers,
        "labels": labels,
        "counts": counts,
        "transition_matrix": transition_probability_matrix(counts),
    }
