"""Port's ``MDTrajectoryDataset`` against the JAX package's, on the CPU:
plain, aligned and graph mode, with extra features and a transform.

Tolerances: plain and graph items are the same numpy arrays (exact). The
aligned frames come from a float32 Kabsch SVD in both packages: within 1e-5
of the frames' scale, and each frame's RMSD to frame 0 within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_tpu.data.pdb import load_pdb as jload_pdb
from twoforone_tpu.data.trajectory import GraphFrame as JGraphFrame
from twoforone_tpu.data.trajectory import MDTrajectoryDataset as JDataset
from twoforone_tpu.ops.geometry import kabsch_rmsd as jkabsch
from twoforone_torch.data.molecules import FOLDED_PDB_DIR
from twoforone_torch.data.pdb import load_pdb
from twoforone_torch.data.trajectory import GraphFrame, MDTrajectoryDataset, backbone_bonds
from twoforone_torch.ops.geometry import kabsch_rmsd


@pytest.fixture(scope="module")
def frames():
    """Rotated and jittered copies of the folded chignolin structure, and
    the two packages' topologies of it."""
    path = os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")
    pdb = load_pdb(path)
    n = pdb.topology.n_atoms
    rng = np.random.default_rng(0)
    base = pdb.xyz.astype(np.float32)
    out = []
    for _ in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        out.append(base @ rot.T + rng.normal(scale=0.01, size=(n, 3)))
    return np.stack(out).astype(np.float32), pdb.topology, jload_pdb(path).topology


def test_plain_mode_with_transform_and_extra_features(frames):
    xyz, top, jtop = frames
    feats = np.arange(6)
    kw = dict(extra_features=feats, transform=lambda c: c * 2.0, timestep=0.2)
    ds, jds = MDTrajectoryDataset(xyz, top, **kw), JDataset(xyz, jtop, **kw)
    assert len(ds) == len(jds) == 6 and ds.timestep == 0.2
    for i in range(6):
        (item, f), (jitem, jf) = ds[i], jds[i]
        assert f == jf == i
        np.testing.assert_array_equal(item, jitem)
        np.testing.assert_array_equal(item, xyz[i] * 2.0)
    with pytest.raises(AssertionError):
        MDTrajectoryDataset(xyz, top, extra_features=np.arange(5))


def test_aligned_mode_matches_jax(frames):
    xyz, top, jtop = frames
    ds, jds = MDTrajectoryDataset(xyz, top, align=True), JDataset(xyz, jtop, align=True)
    assert ds.xyz.dtype == np.float32
    scale = float(np.abs(xyz).max())
    np.testing.assert_allclose(ds.xyz, jds.xyz, atol=1e-5 * scale, rtol=0)
    rms = kabsch_rmsd(torch.from_numpy(ds.xyz), torch.from_numpy(ds.xyz[0])).numpy()
    jrms = np.asarray(jkabsch(jnp.asarray(jds.xyz), jnp.asarray(jds.xyz[0])))
    np.testing.assert_allclose(rms, jrms, atol=1e-5, rtol=0)
    # aligned onto frame 0: the plain distance equals the RMSD up to the jitter
    direct = np.linalg.norm(ds.xyz - ds.xyz[0][None], axis=-1).mean(-1)
    np.testing.assert_allclose(direct[1:], rms[1:], atol=0.02)
    assert len(MDTrajectoryDataset(xyz[:0], top, align=True)) == 0


def test_graph_mode_matches_jax(frames):
    xyz, top, jtop = frames
    n = top.n_atoms
    g = MDTrajectoryDataset(xyz, top, return_bond_graph=True)[0]
    jg = JDataset(xyz, jtop, return_bond_graph=True)[0]
    assert isinstance(g, GraphFrame) and isinstance(jg, JGraphFrame)
    assert g._fields == jg._fields
    for a, b in zip(g, jg):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert g.pos.shape == (n, 3) and g.edge_index.shape == (2, n - 1)
    np.testing.assert_array_equal(g.edge_index[0], np.arange(n - 1))
    np.testing.assert_array_equal(g.edge_index[1], np.arange(1, n))
    assert np.all(g.atom_labels >= 0)
    np.testing.assert_array_equal(backbone_bonds(top), np.stack([np.arange(n - 1),
                                                                  np.arange(1, n)], 1))
    # explicit bonds, a transform and extra features together
    bonds = np.array([[0, 2], [2, 5]])
    kw = dict(return_bond_graph=True, bonds=bonds, transform=lambda c: c + 1.0,
              extra_features=np.arange(6) * 0.5)
    (g, f), (jg, jf) = MDTrajectoryDataset(xyz, top, **kw)[4], JDataset(xyz, jtop, **kw)[4]
    assert f == jf == 2.0
    for a, b in zip(g, jg):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.edge_index, bonds.T)
