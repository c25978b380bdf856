"""Port's evaluation layer against the JAX package's, on the CPU: the
geometry the evaluators read, the metrics, TICA, the golden-reference
loaders, and ``Evaluator.eval`` on the same samples for alanine dipeptide,
chignolin, trp-cage, data-free fast folders with and without a golden TICA
pickle, a fast folder whose TICA is fitted from a data folder, and protein G.

Tolerances: the geometry is float32 in both packages (1e-5 of the largest
distance; angles 1e-5 rad, modulo 2 pi); the metrics, TICA fits and loaders
are the same numpy code on the same arrays (1e-12, loaders exactly). The
results dicts are compared at 1e-6 relative: the features are float32 in
both packages, and a feature sitting on a histogram bin edge could fall on
either side of it; at these sample counts none does. A TICA fitted on each
package's own float32 features whitens their covariance, which magnifies
the features' rounding: its coefficients are held at 1e-4 of the largest
and the score at 1e-3 relative.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import twoforone_tpu.evaluate.deeptime_compat as jdc
import twoforone_tpu.evaluate.evaluators as jev
import twoforone_tpu.evaluate.metrics as jmet
import twoforone_tpu.ops.geometry as jgeo
from twoforone_tpu.evaluate.tica import fit_tica as jfit_tica
import twoforone_torch.evaluate.deeptime_compat as tdc
import twoforone_torch.evaluate.evaluators as tev
import twoforone_torch.evaluate.metrics as tmet
import twoforone_torch.ops.geometry as tgeo
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.data.molecules import SAVED_REFERENCES_DIR
from twoforone_torch.data.synthetic import (
    chain10_dataset,
    chain_dataset,
    chain_trajectory,
    make_chain_components,
)
from twoforone_torch.evaluate.tica import fit_tica


def _coords(n_beads, n, seed):
    if n_beads == 10:
        return chain10_dataset(n, seed=seed)
    return chain_dataset(n, make_chain_components(n_beads - 3, n_slow=4, seed=11), seed=seed)


# -------------------------------------------------------------- geometry
@pytest.mark.parametrize("n_beads,offset", [(5, 1), (10, 1), (10, 3), (28, 3)])
def test_distances_match_jax(n_beads, offset):
    x = _coords(n_beads, 64, 1)
    scale = 1e-5 * float(np.asarray(jgeo.pairwise_distances(jnp.asarray(x))).max())
    np.testing.assert_allclose(tgeo.pairwise_distances(torch.from_numpy(x)).numpy(),
                               np.asarray(jgeo.pairwise_distances(jnp.asarray(x))), atol=scale)
    np.testing.assert_allclose(tgeo.pwd_triu_batch(torch.from_numpy(x), offset).numpy(),
                               np.asarray(jgeo.pwd_triu_batch(x, offset)), atol=scale)
    assert [a.tolist() for a in tgeo.triu_indices(n_beads, offset)] == [
        a.tolist() for a in jgeo.triu_indices(n_beads, offset)]


@pytest.mark.parametrize("n_beads", [5, 10, 20])
def test_dihedrals_match_jax(n_beads):
    x = _coords(n_beads, 128, 2)
    ind = tgeo.sliding_dihedral_indices(n_beads)
    np.testing.assert_array_equal(ind, jgeo.sliding_dihedral_indices(n_beads))
    got = tgeo.dihedrals(torch.from_numpy(x), ind).numpy()
    ref = np.asarray(jgeo.dihedrals(jnp.asarray(x), ind))
    diff = np.abs(got - ref)
    assert np.minimum(diff, 2 * np.pi - diff).max() <= 1e-5
    assert np.abs(got).max() <= np.pi


def test_dihedral_sign_is_mdtraj_convention():
    """A right-handed twist of +90 degrees: b1 = x, b2 = y, b3 = z."""
    p = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 1.0]]])
    got = float(tgeo.dihedrals(p, [[0, 1, 2, 3]])[0, 0])
    assert got == pytest.approx(float(jgeo.dihedrals(jnp.asarray(p.numpy()), [[0, 1, 2, 3]])[0, 0]))
    assert abs(got) == pytest.approx(np.pi / 2)


# --------------------------------------------------------------- metrics
def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    h1, h2 = rng.random(50), rng.random(50)
    h2[:5] = 0
    for name in ("js_divergence",):
        assert getattr(tmet, name)(h1, h2) == pytest.approx(getattr(jmet, name)(h1, h2), rel=1e-12)
    p1, p2 = tmet.normalize_histogram(h1) + 1e-3, tmet.normalize_histogram(h2) + 1e-3
    assert tmet.kl_divergence(p1, p2) == pytest.approx(jmet.kl_divergence(p1, p2), rel=1e-12)
    d1, d2 = rng.random((6, 6)), rng.random((6, 6))
    d1[0, :3] = 0
    for name in ("free_energy_mse", "kl_div_density"):
        assert getattr(tmet, name)(d1, d2) == pytest.approx(getattr(jmet, name)(d1, d2), rel=1e-12)
    assert tmet.K_BT_IN_KCAL_PER_MOL == jmet.K_BT_IN_KCAL_PER_MOL
    x = _coords(5, 2000, 3)
    tors, jtors = tmet.get_torsions(x), jmet.get_torsions(x)
    np.testing.assert_allclose(tors, jtors, atol=1e-5)
    np.testing.assert_allclose(tmet.get_prob(tors), jmet.get_prob(tors), rtol=1e-12)
    np.testing.assert_allclose(tmet.histogram2d_normed(tors[:, 0], tors[:, 1], 10)[0],
                               jmet.histogram2d_normed(tors[:, 0], tors[:, 1], 10)[0])


def test_fit_tica_matches_jax():
    traj = chain_trajectory(3000, make_chain_components(7, n_slow=2, seed=3), seed=0)
    feats = tev.TicEvaluator.get_tic_features(None, traj)
    jfeats = jev.TicEvaluator.get_tic_features(None, traj)
    np.testing.assert_allclose(feats, jfeats, atol=1e-5 * np.abs(jfeats).max())
    got, ref = fit_tica(jfeats, lagtime=100, dim=2), jfit_tica(jfeats, lagtime=100, dim=2)
    for field in ("mean", "coefficients", "singular_values"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(got(jfeats[:10]), ref(jfeats[:10]), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="scaling"):
        fit_tica(jfeats, scaling="other")


_PICKLES = sorted(f for f in os.listdir(SAVED_REFERENCES_DIR)
                  if f.startswith(("saved_TICA_", "saved_pwd_")))


@pytest.mark.parametrize("name", _PICKLES)
def test_reference_loaders_match_jax(name):
    path = os.path.join(SAVED_REFERENCES_DIR, name)
    if name.startswith("saved_TICA_"):
        got, ref = tdc.load_tica_reference(path), jdc.load_tica_reference(path)
        for field in ("mean", "coefficients", "singular_values", "dim"):
            np.testing.assert_array_equal(getattr(got[0], field), getattr(ref[0], field))
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
    else:
        (gmax, ghist), (jmax, jhist) = tdc.load_pwd_reference(path), jdc.load_pwd_reference(path)
        np.testing.assert_array_equal(gmax, jmax)
        assert len(ghist) == len(jhist)
        for a, b in zip(ghist, jhist):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- evaluators
def _both(mol, ref_data, tmp_path, **kw):
    out = []
    for side, mod in (("port", tev), ("jax", jev)):
        folder = tmp_path / side
        folder.mkdir(exist_ok=True)
        out.append(mod.Evaluator(ref_data, None, mol_name=mol, eval_folder=str(folder), **kw))
    return out


def _assert_same_results(ours, theirs, tmp_path, milestone):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-6), k
        assert np.isfinite(ours[k])
    saved = json.load(open(tmp_path / "port" / f"results-{milestone}.json"))
    assert saved == ours


def test_data_free_alanine_has_no_pwd_reference_in_either_package(tmp_path):
    for mod in (tev, jev):
        with pytest.raises(ValueError, match="golden pickle"):
            mod.Evaluator(None, None, mol_name="alanine_dipeptide_fuberlin")


@pytest.mark.parametrize("mol,n_beads,with_data", [
    ("alanine_dipeptide_fuberlin", 5, True),
    ("chignolin", 10, False),
    ("chignolin", 10, True),
    ("trp_cage", 20, False),
    ("bba", 28, False),
    ("villin", 35, False),
    ("protein_g", 56, False),
])
def test_evaluator_matches_jax(mol, n_beads, with_data, tmp_path):
    """Data-free where ``with_data`` is False: the golden TICA pickles
    (chignolin, trp-cage), the offset-3 golden PWD pickles, no TIC metric
    for BBA and villin, and no metric for protein G."""
    ref = _coords(n_beads, 400, 4) if with_data else None
    ours, theirs = _both(mol, ref, tmp_path)
    assert (ours.tic is None) == (theirs.tic is None)
    samples = _coords(n_beads, 500, 5)
    got = ours.eval(samples, milestone="m", save_plots=False)
    want = theirs.eval(samples, milestone="m", save_plots=False)
    _assert_same_results(got, want, tmp_path, "m")
    expected = {"alanine": {"Dihedral JS", "PWD JS"}, "protein_g": set()}.get(
        mol.split("_")[0] if mol.startswith("alanine") else mol,
        {"TIC JS", "PWD JS"} if mol in ("chignolin", "trp_cage") else {"PWD JS"})
    assert set(got) == expected


def test_tic_evaluator_fits_from_a_data_folder(tmp_path):
    """Without a golden TICA pickle (here: one named that does not exist),
    val data and a data folder, the TICA is fitted on the folder's whole
    time-ordered trajectory through the port's own ``get_dataset``."""
    traj = chain_trajectory(4000, make_chain_components(7, n_slow=2, seed=3), seed=0)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "CLN025-0-c-alpha.npy", traj / 10.0)  # nm, as the loader reads it
    val = traj[2800:3200]
    kw = dict(mol_name="chignolin", data_folder=str(data), saved_ref=str(tmp_path / "none.pickle"))
    ours, theirs = tev.TicEvaluator(val, **kw), jev.TicEvaluator(val, **kw)
    for field in ("mean", "coefficients", "singular_values"):
        a, b = getattr(ours.tica, field), getattr(theirs.tica, field)
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
    for a, b in ((ours.bin_edges_x, theirs.bin_edges_x), (ours.bin_edges_y, theirs.bin_edges_y)):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.ptp(b))
    assert (ours.bin_x_folded, ours.bin_y_folded) == (theirs.bin_x_folded, theirs.bin_y_folded)
    samples = traj[::4]
    got, want = ours.eval(samples, plot_tic=False)[0], theirs.eval(samples, plot_tic=False)[0]
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-3)
    with pytest.raises(ValueError, match="golden pickle"):
        tev.TicEvaluator(None, **kw)


def test_evaluator_plots_as_jax(tmp_path):
    """save_plots=True draws the same files in both packages."""
    for mol, n in (("chignolin", 10), ("alanine_dipeptide_fuberlin", 5)):
        ours, theirs = _both(mol, _coords(n, 200, 4) if n == 5 else None, tmp_path)
        samples = _coords(n, 300, 6)
        ours.eval(samples, milestone=f"p{n}", save_plots=True)
        theirs.eval(samples, milestone=f"p{n}", save_plots=True)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "port"))


def test_pwd_evaluator_errors_match_jax(tmp_path):
    for mod in (tev, jev):
        with pytest.raises(FileNotFoundError):
            mod.PwdEvaluator(mol_name="chignolin", saved_ref=str(tmp_path / "absent.pickle"))
        ev = mod.PwdEvaluator(mol_name="chignolin", evalset="testset")
        assert ev.offset == 3
        with pytest.raises(ValueError, match="pair-count mismatch"):
            ev.eval(_coords(20, 10, 0))
        with pytest.raises(ValueError, match="golden pickle"):
            mod.PwdEvaluator(mol_name="")
