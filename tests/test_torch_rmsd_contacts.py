"""Port's Kabsch geometry and its RMSD and contact evaluators against the
JAX package's, on the CPU.

Tolerances: superposition and RMSD are float32 in both packages (a batched
SVD each), held within 1e-5 of the frames' scale (their largest absolute
coordinate). The aligned frames are compared, never the singular vectors,
which are defined only up to sign. The evaluators' numpy around the geometry
is the same code: histograms and the BCE are compared exactly where the
inputs agree exactly, and at 1e-6 relative where they come from the float32
RMSD. Contact maps are compared on float64 distances in both packages, so
that no pair sits on the cutoff by float32 rounding.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import twoforone_tpu.evaluate.evaluators as jev
import twoforone_tpu.ops.geometry as jgeo
import twoforone_torch.evaluate.evaluators as tev
import twoforone_torch.ops.geometry as tgeo
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.data.molecules import FOLDED_PDB_DIR
from twoforone_torch.data.pdb import load_pdb

TOL = 1e-5  # of the frames' scale


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def _frames(case):
    """(frames (B, N, 3), reference (N, 3)) float32 of one geometric case."""
    rng = np.random.default_rng(0)
    ref = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).xyz.astype(np.float64)
    b, n = 16, ref.shape[0]
    if case == "random":
        xyz = rng.normal(size=(b, n, 3)) * 5.0 + 2.0
    elif case == "rotated":
        # rotated, shifted and jittered copies of the reference
        xyz = np.einsum("bij,nj->bni", _rotations(rng, b), ref) + rng.normal(size=(b, 1, 3))
        xyz += rng.normal(scale=0.05, size=xyz.shape)
    elif case == "planar":
        # frames and reference in the z = 0 plane: a rank-2 covariance
        xyz = rng.normal(size=(b, n, 3)) * 5.0
        xyz[..., 2] = 0.0
        ref = ref.copy()
        ref[:, 2] = 0.0
    elif case == "collinear":
        # every frame on a line: a rank-1 covariance
        xyz = rng.normal(size=(b, n, 1)) * rng.normal(size=(b, 1, 3)) * 3.0
    elif case == "identity":
        # the reference itself, shifted: RMSD 0, where sqrt of a rounding
        # below zero would give nan
        xyz = ref[None].repeat(b, axis=0) + rng.normal(size=(b, 1, 3))
    return xyz.astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "rotated", "planar", "collinear", "identity"])
def test_superpose_and_kabsch_rmsd_match_jax(case):
    xyz, ref = _frames(case)
    scale = float(np.abs(xyz).max())
    t_al = tgeo.superpose(torch.from_numpy(xyz), torch.from_numpy(ref)).numpy()
    j_al = np.asarray(jgeo.superpose(jnp.asarray(xyz), jnp.asarray(ref)))
    np.testing.assert_allclose(t_al, j_al, atol=TOL * scale, rtol=0)
    t_rmsd = tgeo.kabsch_rmsd(torch.from_numpy(xyz), torch.from_numpy(ref)).numpy()
    j_rmsd = np.asarray(jgeo.kabsch_rmsd(jnp.asarray(xyz), jnp.asarray(ref)))
    assert np.isfinite(t_rmsd).all()
    np.testing.assert_allclose(t_rmsd, j_rmsd, atol=TOL * scale, rtol=0)
    # The RMSD is that of the aligned frames to the centred reference.
    r = ref - ref.mean(0) + t_al.mean(1, keepdims=True)
    direct = np.sqrt(((t_al - r) ** 2).sum(-1).mean(-1))
    np.testing.assert_allclose(t_rmsd, direct, atol=TOL * scale, rtol=0)
    if case == "identity":
        assert t_rmsd.max() <= TOL * scale
    if case == "rotated":
        assert t_rmsd.max() < 0.2  # jitter of 0.05 per coordinate


@pytest.mark.parametrize("method", ["sum", "mean"])
def test_unsorted_segment_sum_matches_jax(method):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 7, size=30)
    ids[ids == 3] = 2  # an empty segment: the mean divides by at least 1
    t = tgeo.unsorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7, 2.0, method)
    j = jgeo.unsorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), 7, 2.0, method)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
    assert (t.numpy()[3] == 0).all()
    with pytest.raises(ValueError):
        tgeo.unsorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7, 2.0, "max")


def test_rmsd_reference_pickle_matches_jax():
    t_ev, j_ev = tev.RmsdEvaluator("chignolin"), jev.RmsdEvaluator("chignolin")
    t_ref = t_ev.eval("Reference", cutoff=10, nbins=100)
    j_ref = j_ev.eval("Reference", cutoff=10, nbins=100)
    assert t_ref.keys() == j_ref.keys() and "bin_mids" in t_ref and "energies" in t_ref
    for k in t_ref:
        np.testing.assert_array_equal(t_ref[k], j_ref[k])
    # The staged curve exists at 100 bins and the molecule's cutoff only.
    for ev in (t_ev, j_ev):
        with pytest.raises(AssertionError):
            ev.eval("Reference", cutoff=12, nbins=100)
        with pytest.raises(AssertionError):
            ev.eval("Reference", cutoff=10, nbins=50)


@pytest.mark.parametrize("cutoff", [10.0, None])
def test_rmsd_evaluator_matches_jax_with_nan_frames(cutoff):
    t_ev, j_ev = tev.RmsdEvaluator("chignolin"), jev.RmsdEvaluator("chignolin")
    rng = np.random.default_rng(2)
    folded = t_ev.folded.xyz
    xyz = (folded[None] + rng.normal(scale=1.5, size=(200, 10, 3))).astype(np.float32)
    xyz[[3, 50]] = np.nan
    xyz[77, 4, 1] = np.inf
    t = t_ev.eval("samples", xyz, nbins=40, cutoff=cutoff, save_dynamics=True)
    j = j_ev.eval("samples", xyz, nbins=40, cutoff=cutoff, save_dynamics=True)
    np.testing.assert_array_equal(np.isnan(t["rmsd"]), np.isnan(j["rmsd"]))
    assert np.isnan(t["rmsd"][[3, 50, 77]]).all() and np.isfinite(t["rmsd"]).sum() == 197
    ok = ~np.isnan(t["rmsd"])
    np.testing.assert_allclose(t["rmsd"][ok], j["rmsd"][ok], atol=TOL * 10, rtol=0)
    np.testing.assert_allclose(t["bin_mids"], j["bin_mids"], rtol=1e-6)
    np.testing.assert_allclose(t["energies"], j["energies"], rtol=1e-6)
    # the folded structure itself: RMSD 0
    d = t_ev.eval("self", folded[None].repeat(4, axis=0), nbins=10, cutoff=10,
                  save_dynamics=True)
    assert d["rmsd"] == pytest.approx(np.zeros(4), abs=1e-3)


def test_contact_evaluator_matches_jax_in_float64():
    t_ev = tev.ContactEvaluator("chignolin")
    rng = np.random.default_rng(3)
    folded = t_ev.folded.astype(np.float64)
    xyz = folded[None] + rng.normal(scale=3.0, size=(64, 10, 3))
    with jax.enable_x64(True):
        j_ev = jev.ContactEvaluator("chignolin")
        j_contacts = j_ev.get_contacts(xyz)
        j_count = j_ev.normalized_contact_count(xyz)
        j_bce = j_ev.bce_dynamics(xyz)
    np.testing.assert_array_equal(t_ev.contacts_folded, j_ev.contacts_folded)
    np.testing.assert_array_equal(t_ev.get_contacts(xyz), j_contacts)
    np.testing.assert_array_equal(t_ev.normalized_contact_count(xyz), j_count)
    np.testing.assert_array_equal(t_ev.bce_dynamics(xyz), j_bce)
    # BCE: 0 on the folded structure, > 1 on a random coil, and the log
    # clamp at -100 keeps it finite.
    assert t_ev.eval_bce(t_ev.folded[None].repeat(3, axis=0)) == pytest.approx(0.0, abs=1e-9)
    coil = rng.normal(size=(3, 10, 3)).astype(np.float32) * 20
    bce = t_ev.eval_bce(coil)
    assert 1.0 < bce <= 100.0 and bce == pytest.approx(j_ev.eval_bce(coil), rel=1e-12)


def test_rmsd_and_contact_plots(tmp_path):
    folded = tev.ContactEvaluator("chignolin").folded
    rng = np.random.default_rng(4)
    xyz = (folded[None] + rng.normal(scale=2.0, size=(50, 10, 3))).astype(np.float32)
    results = {}
    for name, ev_mod in (("port", tev), ("jax", jev)):
        out = tmp_path / name
        out.mkdir()
        rm = ev_mod.RmsdEvaluator("chignolin", eval_folder=str(out))
        rm.eval("Reference", cutoff=10, nbins=100)
        rm.eval("samples", xyz, nbins=100, cutoff=10)
        rm.plot()
        ce = ev_mod.ContactEvaluator("chignolin", eval_folder=str(out))
        results[name] = (ce.plot_contact_normcount(xyz, "samples"),
                         ce.plot_contact_normcount(xyz, "log", take_log=True))
        assert (out / "RMSD_chignolin_free_energy.png").stat().st_size > 0
        assert (out / "contact_normcount_chignolin_samples.png").stat().st_size > 0
        assert (out / "contact_normcount_chignolin_log.png").stat().st_size > 0
    np.testing.assert_allclose(results["port"], results["jax"], rtol=1e-6)


def test_evaluate_package_exports_equal_jax():
    import twoforone_tpu.evaluate as jpkg
    import twoforone_torch.evaluate as tpkg

    def exported(mod):
        return {n for n in vars(mod) if not n.startswith("_") and callable(getattr(mod, n))}

    assert exported(tpkg) == exported(jpkg) and len(exported(tpkg)) == 21
    assert tpkg.RmsdEvaluator is tev.RmsdEvaluator and tpkg.ContactEvaluator is tev.ContactEvaluator
