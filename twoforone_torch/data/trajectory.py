"""Generic MD-trajectory dataset with optional bond-graph items (port of
``twoforone_tpu/data/trajectory.py``).

A frame-indexable dataset over a trajectory with optional Kabsch alignment
to frame 0 (:func:`twoforone_torch.ops.geometry.superpose`, float32), per-item
transforms, extra per-frame features, and a "graph mode"
(``return_bond_graph=True``) that yields each frame as a :class:`GraphFrame`
NamedTuple of numpy arrays (positions, atom labels, edge index): the fields
of a ``torch_geometric.data.Data`` without that dependency.

Bonds come from an explicit ``bonds`` argument when given, else the
sequential backbone of each chain: exact for the CG bead chains modelled
here (every staged molecule is a linear C-alpha trace). The PDB parser keeps
no bond table.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from twoforone_torch.data.pdb import Topology
from twoforone_torch.ops.geometry import superpose

# Atomic numbers for the elements that occur in the shipped CG/atomistic PDBs.
_ATOMIC_NUMBERS = {
    "H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "NA": 11, "MG": 12, "P": 15,
    "S": 16, "CL": 17, "K": 19, "CA": 20, "FE": 26, "ZN": 30, "BR": 35,
    "I": 53,
}


class GraphFrame(NamedTuple):
    """One trajectory frame as a graph (the fields of a torch_geometric
    ``Data``)."""

    pos: np.ndarray  # (N, 3) float32
    atom_labels: np.ndarray  # (N,) int32, atomic_number - 1
    edge_index: np.ndarray  # (2, E) int32


def backbone_bonds(topology: Topology) -> np.ndarray:
    """(E, 2) consecutive-bead bonds within each chain."""
    pairs = []
    atoms = topology.atoms
    for i in range(len(atoms) - 1):
        if atoms[i].chain == atoms[i + 1].chain:
            pairs.append((i, i + 1))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def _atom_labels(topology: Topology) -> np.ndarray:
    labels = []
    for a in topology.atoms:
        el = (a.element or a.name[:1]).upper()
        z = _ATOMIC_NUMBERS.get(el, _ATOMIC_NUMBERS.get(el[:1], 6))
        labels.append(z - 1)
    return np.asarray(labels, dtype=np.int32)


class MDTrajectoryDataset:
    """Frame dataset over an MD trajectory.

    Args:
      xyz: (n_frames, n_atoms, 3) coordinates.
      topology: the molecule's topology.
      extra_features: optional per-frame features, same length as the
        trajectory.
      transform: applied to the coordinates of each returned item.
      return_bond_graph: yield :class:`GraphFrame` items instead of raw
        coordinate arrays.
      timestep: frame spacing in picoseconds.
      align: Kabsch-superpose every frame onto frame 0 before serving.
      bonds: explicit (E, 2) bond list; default = sequential backbone.
    """

    def __init__(
        self,
        xyz: np.ndarray,
        topology: Topology,
        extra_features: Optional[Sequence] = None,
        transform: Optional[Callable] = None,
        return_bond_graph: bool = False,
        timestep: Optional[float] = None,
        align: bool = False,
        bonds: Optional[np.ndarray] = None,
    ):
        xyz = np.asarray(xyz, dtype=np.float32)
        if align and len(xyz) > 0:
            t = torch.from_numpy(xyz)
            xyz = superpose(t, t[0]).numpy()
        self.xyz = xyz
        self.topology = topology
        if extra_features is not None:
            assert len(extra_features) == len(xyz), (
                "The extra features must have the same length as the trajectory"
            )
        self.extra_features = extra_features
        self.transform = transform
        self.return_bond_graph = return_bond_graph
        self.timestep = timestep
        if return_bond_graph:
            b = backbone_bonds(topology) if bonds is None else np.asarray(bonds)
            self.edge_index = b.T.astype(np.int32)  # (2, E)
            self.atom_labels = _atom_labels(topology)

    def __len__(self) -> int:
        return len(self.xyz)

    def __getitem__(self, idx):
        x = self.xyz[idx]
        if self.transform is not None:
            x = self.transform(x)
        if self.return_bond_graph:
            item = GraphFrame(
                pos=np.asarray(x, np.float32),
                atom_labels=self.atom_labels,
                edge_index=self.edge_index,
            )
        else:
            item = x
        if self.extra_features is not None:
            return item, self.extra_features[idx]
        return item
