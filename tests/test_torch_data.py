"""Port's data layer (molecule tables, PDB I/O, datasets, synthetic systems)
against the JAX package's, on the same files and seeds.

Both packages are numpy code here, so the port is held to equality: the same
topologies, coordinates, splits and bytes written.
"""

import dataclasses
import os

import numpy as np
import pytest

from twoforone_tpu.data import datasets as jds
from twoforone_tpu.data import molecules as jmol
from twoforone_tpu.data import pdb as jpdb
from twoforone_tpu.data import synthetic as jsyn
from twoforone_torch.data import datasets as tds
from twoforone_torch.data import molecules as tmol
from twoforone_torch.data import pdb as tpdb
from twoforone_torch.data import synthetic as tsyn

PROTEINS = {"chignolin": 10, "trp_cage": 20, "bba": 28, "villin": 35, "protein_g": 56}
# The molecules of the staged configs (assets/trained/*/config.json).
STAGED_MOLS = ["alanine_dipeptide_fuberlin", "chignolin", "trp_cage", "bba", "villin",
               "protein_g"]


def _same_structure(got, ref):
    assert [dataclasses.astuple(a) for a in got.topology.atoms] == \
        [dataclasses.astuple(a) for a in ref.topology.atoms]
    assert got.xyz.dtype == ref.xyz.dtype
    np.testing.assert_array_equal(got.xyz, ref.xyz)


def test_molecule_tables_and_paths_match_jax():
    for name in ("norm_stds", "temp_dict", "temp_dict_pt", "langevin_dt_scale_dict",
                 "all_molecules", "MASS_ALA2", "MASS_FASTFOLDER", "KB", "KBOLTZMANN",
                 "AVOGADRO", "JPERKCAL"):
        got, ref = getattr(tmol, name), getattr(jmol, name)
        if name == "norm_stds":  # keyed by each package's own enum
            got = {getattr(k, "name", k): v for k, v in got.items()}
            ref = {getattr(k, "name", k): v for k, v in ref.items()}
        assert got == ref, name
    for name in ("ASSETS_DIR", "FOLDED_PDB_DIR", "SAVED_REFERENCES_DIR"):
        assert os.path.samefile(getattr(tmol, name), getattr(jmol, name)), name
    for mol in ["alanine_dipeptide_fuberlin", *PROTEINS, "ww_domain", "ntl9"]:
        for n in (None, 10, 30, 60):
            assert tmol.default_dt_scale(mol, n) == jmol.default_dt_scale(mol, n)
        for ca_only in (True, False):
            assert os.path.realpath(tmol.folded_pdb_path(mol, ca_only)) == \
                os.path.realpath(jmol.folded_pdb_path(mol, ca_only))


@pytest.mark.parametrize("mol", [*PROTEINS, "alanine_dipeptide"])
def test_load_pdb_matches_jax(mol):
    """C-alpha files (one bead a residue) and the CG alanine dipeptide (five
    beads on three residues): same atoms, same coordinates."""
    path = tmol.folded_pdb_path(mol)
    got, ref = tpdb.load_pdb(path), jpdb.load_pdb(path)
    _same_structure(got, ref)
    n, residues = (PROTEINS[mol],) * 2 if mol in PROTEINS else (5, 3)
    assert (got.topology.n_atoms, got.topology.n_residues) == (n, residues)


@pytest.mark.parametrize("mol", list(PROTEINS))
def test_process_pdb_matches_jax(mol):
    """Full folded structures sliced to C-alpha beads (protein G's special
    case included), with solvent removed."""
    path = tmol.folded_pdb_path(mol, ca_only=False)
    got = tpdb.process_pdb(path, mol)
    _same_structure(got, jpdb.process_pdb(path, mol))
    assert got.xyz.shape == (PROTEINS[mol], 3)
    assert got.topology.ca_indices().tolist() == list(range(PROTEINS[mol]))


@pytest.mark.parametrize("mol", ["chignolin", "protein_g", "alanine_dipeptide"])
def test_save_pdb_writes_the_jax_bytes_and_reloads(mol, tmp_path):
    """A three-frame trajectory (one frame 2-D) written by both packages: the
    same bytes; reloaded through the port, the first model's coordinates to
    the file's 1e-3 Angstrom."""
    s = tpdb.load_pdb(tmol.folded_pdb_path(mol))
    frames = np.stack([s.xyz, s.xyz + 1.0, -s.xyz]).astype(np.float32)
    for name, xyz in (("multi", frames), ("single", frames[1])):
        ours, theirs = tmp_path / f"{name}_torch.pdb", tmp_path / f"{name}_jax.pdb"
        tpdb.save_pdb(str(ours), xyz, s.topology)
        jpdb.save_pdb(str(theirs), xyz, jpdb.load_pdb(tmol.folded_pdb_path(mol)).topology)
        assert ours.read_bytes() == theirs.read_bytes()
        back = tpdb.load_pdb(str(ours))
        assert back.topology.n_residues == s.topology.n_residues
        np.testing.assert_allclose(back.xyz, xyz if xyz.ndim == 2 else xyz[0], atol=1e-3)
        _same_structure(back, jpdb.load_pdb(str(ours)))
    with pytest.raises(AssertionError, match="topology"):
        tpdb.save_pdb(str(tmp_path / "bad.pdb"), frames[:, :-1], s.topology)


def _same_dataset(got, ref):
    assert got.is_empty == ref.is_empty and len(got) == len(ref)
    assert got.std == ref.std and got.num_beads == ref.num_beads and got.mean0 == ref.mean0
    assert str(getattr(got.molecule, "name", got.molecule)) == \
        str(getattr(ref.molecule, "name", ref.molecule))
    np.testing.assert_array_equal(got.bead_onehot, ref.bead_onehot)
    assert [dataclasses.astuple(a) for a in got.topology.atoms] == \
        [dataclasses.astuple(a) for a in ref.topology.atoms]
    if not got.is_empty:
        assert got.data.dtype == ref.data.dtype
        np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("mol", STAGED_MOLS)
def test_empty_dataset_mode_matches_jax(mol):
    """``data_folder=None``: three copies of one empty dataset with the
    topology, std and one-hot of the molecule."""
    kw = dict(fold=1) if "alanine" in mol else {}
    got, ref = tds.get_dataset(mol, True, None, **kw), jds.get_dataset(mol, True, None, **kw)
    for g, r in zip(got, ref):
        _same_dataset(g, r)
    assert got[0] is got[1] is got[2] and got[0].is_empty
    with pytest.raises(ValueError, match="Wrong dataset"):
        tds.get_dataset("alanine_dipeptide_mdshare", True)


@pytest.mark.parametrize("fold", [1, 2, 3, 4])
def test_ala2_folds_and_seeded_split_match_jax(fold, tmp_path):
    """n = 4002 frames, where torch.chunk's boundaries (every chunk ceil(n/4),
    a short last one) differ from np.array_split's: the test chunk, the
    seeded train/val split under a small train cap and the train subset are
    the JAX package's."""
    import torch

    n = 4002
    coords = np.random.default_rng(3).normal(size=(n, 5, 3)).astype(np.float32)
    np.savez(tmp_path / "ala2_cg_2fs_Hmass_2_HBonds.npz", coords=coords)
    for kw in (dict(), dict(ala2_train_cap=2000, traindata_subset=700)):
        args = ("alanine_dipeptide_fuberlin", True, str(tmp_path), fold)
        got, ref = tds.get_dataset(*args, **kw), jds.get_dataset(*args, **kw)
        for g, r in zip(got, ref):
            _same_dataset(g, r)
    chunk = torch.arange(n).chunk(4)[fold - 1].numpy()
    test = got[2].data
    np.testing.assert_allclose(test, coords[chunk] - coords[chunk].mean(axis=1, keepdims=True),
                               atol=1e-5)
    assert len(got[0]) == 700 and len(got[1]) == n - len(chunk) - 2000


@pytest.mark.parametrize("ext,shuffle", [(".npy", True), (".npy", False), (".npz", True)])
def test_deshaw_split_matches_jax(ext, shuffle, tmp_path):
    """A preprocessed fast-folder file in nm: Angstrom, centring, the
    fixed-seed shuffle and the sequential 70/10/20 split."""
    coords_nm = np.random.default_rng(1).normal(size=(1000, 10, 3)).astype(np.float32)
    if ext == ".npy":
        np.save(tmp_path / "CLN025-0-c-alpha.npy", coords_nm)
    else:
        np.savez(tmp_path / "CLN025-0-c-alpha.npz", coords=coords_nm)
    args = ("chignolin", True, str(tmp_path))
    got = tds.get_dataset(*args, shuffle_before_splitting=shuffle)
    ref = jds.get_dataset(*args, shuffle_before_splitting=shuffle)
    for g, r in zip(got, ref):
        _same_dataset(g, r)
    assert [len(d) for d in got] == [700, 100, 200]
    with pytest.raises(FileNotFoundError, match="TRP_CAGE"):
        tds.get_dataset("trp_cage", True, str(tmp_path))


def test_raw_trajectory_layout_needs_mdtraj(tmp_path):
    """The csv-indexed trajectory layout imports mdtraj only when it is
    found, and says so when mdtraj is missing; the port does as the JAX
    package does either way."""
    sim = tmp_path / "CLN025" / "simulation_0" / "c-alpha" / "CLN025-0-c-alpha"
    sim.mkdir(parents=True)
    (sim / "CLN025-0-c-alpha_times.csv").write_text("0,part0.dcd\n")
    try:
        import mdtraj  # noqa: F401
    except ImportError:
        for mod in (tds, jds):
            with pytest.raises(ImportError, match="mdtraj"):
                mod.get_dataset("chignolin", True, str(tmp_path))
    else:  # pragma: no cover - mdtraj is not installed where the tests run
        pytest.fail("mdtraj is installed: this case needs a trajectory file")


def test_prepare_shuffle_matches_jax_and_restores_global_state():
    """The fixed-seed shuffle (np.random.seed(2342361); np.random.shuffle) on
    a copy of the data, leaving numpy's global state as it found it."""
    data = np.random.default_rng(3).normal(size=(50, 4, 3)).astype(np.float32)
    for mean0, shuffle in ((False, True), (True, True), (True, False)):
        np.random.seed(7)
        got = tds.CGDataset.prepare(data.copy(), mean0, shuffle)
        after = np.random.random()
        np.random.seed(7)
        ref = jds.CGDataset.prepare(data.copy(), mean0, shuffle)
        assert np.random.random() == after
        np.testing.assert_array_equal(got, ref)
    expected = data.copy()
    np.random.seed(2342361)
    np.random.shuffle(expected)
    np.testing.assert_array_equal(tds.CGDataset.prepare(data.copy(), False, True), expected)
    np.testing.assert_array_equal(tds.to_angstrom(data), jds.to_angstrom(data))


SYNTHETIC = {
    "chain10_dataset": lambda m: m.chain10_dataset(64, seed=1),
    "chain10_trajectory": lambda m: m.chain10_trajectory(60, seed=2, walkers=6),
    "bimodal_dipeptide_dataset": lambda m: m.bimodal_dipeptide_dataset(64, seed=3),
    "chain_dataset_n20": lambda m: m.chain_dataset(32, m.make_chain_components(17, 4), seed=4),
    "chain_trajectory_n20": lambda m: m.chain_trajectory(
        40, m.make_chain_components(17, 4, seed=5), seed=5, walkers=4, sigma=0.5),
    "make_chain_components": lambda m: np.asarray(
        [c for comp in m.make_chain_components(32, n_slow=3, seed=9) for c in comp]),
    "sample_torsion_mixture": lambda m: m.sample_torsion_mixture(
        np.random.default_rng(6), 500, m.PSI_COMPONENTS),
    "metropolis_torsion_walk": lambda m: m.metropolis_torsion_walk(
        np.random.default_rng(7), 30, m.CHAIN10_TORSION_COMPONENTS[2], 0.4, 5),
    "mixture_logp": lambda m: m.mixture_logp(np.linspace(-3, 3, 41), m.PHI_COMPONENTS),
    "build_chain_n": lambda m: m.build_chain_n(
        np.full((3, 9), 1.5), np.full((3, 8), 1.9),
        np.random.default_rng(8).uniform(-3, 3, size=(3, 7))),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_generators_match_jax(name):
    """Same seed, same numbers: the generators are the JAX package's numpy
    code, so the arrays are equal."""
    got, ref = SYNTHETIC[name](tsyn), SYNTHETIC[name](jsyn)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_synthetic_chain_torsion_roundtrip():
    """The port's NeRF construction reproduces prescribed torsions under the
    mdtraj sign convention (read back by the JAX package's ``get_torsions``),
    and its mixture sampler hits the basin weights."""
    from twoforone_tpu.evaluate.metrics import get_torsions

    b = np.full((4, 4), 1.53)
    a = np.full((4, 3), 1.937)
    tors = np.array([[-1.2, -2.0], [1.1, 0.6], [2.5, -0.3], [0.0, 3.0]])
    rec = get_torsions(tsyn.build_chain(b, a, tors))
    np.testing.assert_allclose(rec, tors, atol=1e-5)
    t = tsyn.sample_torsion_mixture(np.random.default_rng(0), 20000,
                                    ((0.7, -1.0, 50.0), (0.3, 1.5, 50.0)))
    assert abs((t > 0.25).mean() - 0.3) < 0.02
    data = tsyn.bimodal_dipeptide_dataset(512, seed=1)
    assert data.shape == (512, 5, 3) and data.dtype == np.float32
    np.testing.assert_allclose(data.mean(axis=1), 0.0, atol=1e-5)
