"""Port's kinetics (TIC-space clustering, transition counts) and ergodicity
(basin exchange on slow torsions) against the JAX package's, on the CPU.

Both modules are numpy in both packages; every result is compared exactly.
The ergodicity report reads float32 dihedrals in both (the JAX package's
jnp, the port's torch): a frame's basin label could differ only for an
angle within rounding of a basin boundary, and on these cases none is.
"""

import numpy as np
import pytest

import twoforone_tpu.evaluate.ergodicity as jerg
import twoforone_tpu.evaluate.kinetics as jkin
import twoforone_torch.evaluate.ergodicity as terg
import twoforone_torch.evaluate.kinetics as tkin
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.data.synthetic import _chain_frames, metropolis_torsion_walk

BIMODAL = ((0.6, -1.2, 8.0), (0.4, 1.4, 8.0))
UNIMODAL = ((1.0, 0.8, 10.0),)


def _equal(a, b):
    """Exact equality of nested results (dicts, arrays, numbers)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert type(a) is type(b) or isinstance(a, np.ndarray), (type(a), type(b))
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ kinetics
def test_assign_clusters():
    centers = np.array([[0.0, 0.0], [10.0, 10.0]])
    tics = np.array([[0.1, -0.2], [9.5, 10.2], [1.0, 1.0]])
    got = tkin.assign_clusters(tics, centers)
    np.testing.assert_array_equal(got, [0, 1, 0])
    _equal(got, jkin.assign_clusters(tics, centers))


def test_kmeans_and_transitions():
    rng = np.random.default_rng(0)
    tics = np.concatenate([rng.normal(size=(500, 2)) * 0.2,
                           rng.normal(size=(500, 2)) * 0.2 + 5.0])
    centers = tkin.kmeans_centers(tics, 2, seed=0)
    assert centers.shape == (2, 2)
    _equal(centers, jkin.kmeans_centers(tics, 2, seed=0))
    labels = np.array([0, 0, 0, 1, 1, 1, 0, 0, 1])
    for lag in (1, 2):
        for sliding in (True, False):
            counts = tkin.transition_count_matrix(labels, 2, lagtime=lag, sliding=sliding)
            _equal(counts, jkin.transition_count_matrix(labels, 2, lagtime=lag, sliding=sliding))
    counts = tkin.transition_count_matrix(labels, 2, lagtime=1)
    assert counts.sum() == len(labels) - 1
    assert counts[0, 0] == 3 and counts[0, 1] == 2 and counts[1, 1] == 2
    p = tkin.transition_probability_matrix(counts)
    np.testing.assert_allclose(p.sum(axis=1), [1.0, 1.0])
    _equal(p, jkin.transition_probability_matrix(counts))
    # a state never left: its row stays zero
    empty = np.array([[2, 1, 0], [0, 0, 0], [1, 0, 1]])
    _equal(tkin.transition_probability_matrix(empty), jkin.transition_probability_matrix(empty))


def test_transition_counts_multi_chain_and_lag():
    labels = np.array([[0, 1, 0, 1], [1, 1, 1, 1]])
    counts = tkin.transition_count_matrix(labels, 2, lagtime=2)
    assert counts[0, 0] == 1 and counts[1, 1] == 3
    _equal(counts, jkin.transition_count_matrix(labels, 2, lagtime=2))
    ragged = [np.array([0, 1, 2]), np.array([2]), np.array([1, 1, 0, 2])]
    _equal(tkin.transition_count_matrix(ragged, 3), jkin.transition_count_matrix(ragged, 3))


@pytest.mark.parametrize("given_centers", [True, False])
def test_tic_state_analysis_matches_jax(given_centers):
    rng = np.random.default_rng(5)
    traj = rng.normal(size=(3, 40, 6, 3))
    coef = rng.normal(size=(6 * 3, 2))

    def features(flat):
        return flat.reshape(len(flat), -1)

    def projection(feats):
        return feats @ coef

    centers = np.array([[-2.0, 0.0], [0.0, 0.0], [2.0, 1.0]]) if given_centers else None
    kw = dict(centers=centers, n_clusters=3, lagtime=2, seed=1)
    got = tkin.tic_state_analysis(projection, features, traj, **kw)
    _equal(got, jkin.tic_state_analysis(projection, features, traj, **kw))
    assert got["labels"].shape == (3, 40) and got["counts"].sum() == 3 * 38


# ---------------------------------------------------------------- ergodicity
def test_basin_labels_match_jax():
    theta = np.array([-1.2, 1.4, -1.0, 1.2, (-1.2 + 1.4) / 2])
    got = terg.basin_labels(theta, BIMODAL)
    assert got.tolist() == [0, 1, 0, 1, 0]  # the heavier component wins the midpoint
    _equal(got, jerg.basin_labels(theta, BIMODAL))
    grid = np.linspace(-np.pi, np.pi, 997).reshape(997, 1)
    _equal(terg.basin_labels(grid, BIMODAL), jerg.basin_labels(grid, BIMODAL))


def test_hop_statistics_frozen_vs_alternating():
    frozen = np.zeros((8, 100), dtype=int)
    frozen[4:] = 1
    alternating = np.tile([0, 1], 50)[None, :].repeat(8, axis=0)
    for labels, hop in ((frozen, 0.0), (alternating, 1.0)):
        s = terg.hop_statistics(labels)
        assert s["hop_fraction"] == hop and s["hops_per_frame"] == hop
        _equal(s, jerg.hop_statistics(labels))


def _frames_from_torsions(torsions_cf):
    """(chains, frames, k) torsions -> (chains, frames, k+3, 3) coords."""
    chains, frames, k = torsions_cf.shape
    flat = _chain_frames(np.random.default_rng(3), torsions_cf.reshape(chains * frames, k))
    return flat.reshape(chains, frames, k + 3, 3)


def _frozen_traj():
    rng = np.random.default_rng(0)
    chains, frames = 20, 60
    slow = np.where(np.arange(chains) < 12, -1.2, 1.4)[:, None].repeat(frames, 1)
    slow = slow + 0.05 * rng.normal(size=slow.shape)
    fast0 = rng.vonmises(0.8, 10.0, size=(chains, frames))
    fast1 = rng.vonmises(0.8, 10.0, size=(chains, frames))
    return _frames_from_torsions(np.stack([fast0, slow, fast1], axis=-1))


def _metropolis_traj():
    rng = np.random.default_rng(1)
    chains, frames = 16, 400
    slow = metropolis_torsion_walk(rng, frames, BIMODAL, sigma=1.2, walkers=chains)
    fast0 = rng.vonmises(0.8, 10.0, size=(chains, frames))
    fast1 = rng.vonmises(0.8, 10.0, size=(chains, frames))
    return _frames_from_torsions(np.stack([fast0, slow, fast1], axis=-1))


def test_frozen_chains_fail_ergodicity_despite_correct_occupancy():
    components = [UNIMODAL, BIMODAL, UNIMODAL]
    traj = _frozen_traj()
    erg = terg.slow_torsion_ergodicity(traj, components)
    _equal(erg, jerg.slow_torsion_ergodicity(traj, components))
    assert list(erg["per_torsion"].keys()) == [1]
    assert erg["min_hop_fraction"] == 0.0 and not erg["ergodic"]
    assert erg["max_occupancy_error"] < 0.05


def test_metropolis_chains_are_ergodic():
    components = [UNIMODAL, BIMODAL, UNIMODAL]
    traj = _metropolis_traj()
    erg = terg.slow_torsion_ergodicity(traj, components)
    _equal(erg, jerg.slow_torsion_ergodicity(traj, components))
    assert erg["ergodic"] and erg["min_hop_fraction"] > 0.9
    assert erg["max_occupancy_error"] < 0.1
    strict = terg.slow_torsion_ergodicity(traj, components, min_hop_fraction=0.999)
    _equal(strict, jerg.slow_torsion_ergodicity(traj, components, min_hop_fraction=0.999))


def test_all_unimodal_system_is_trivially_ergodic():
    traj = _frames_from_torsions(np.random.default_rng(2).vonmises(0.8, 10.0, size=(4, 10, 2)))
    erg = terg.slow_torsion_ergodicity(traj, [UNIMODAL, UNIMODAL])
    assert erg["ergodic"] and erg["per_torsion"] == {}
    _equal(erg, jerg.slow_torsion_ergodicity(traj, [UNIMODAL, UNIMODAL]))


def test_shape_validation():
    with pytest.raises(ValueError):
        terg.slow_torsion_ergodicity(np.zeros((10, 5, 3)), [BIMODAL])
    with pytest.raises(ValueError):
        terg.hop_statistics(np.zeros(10, dtype=int))
