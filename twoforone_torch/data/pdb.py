"""Minimal PDB I/O and topology handling, without mdtraj (copy of
``twoforone_tpu/data/pdb.py``).

Parses ATOM/HETATM records, removes solvent, slices C-alpha beads and
writes multi-frame coarse-grained trajectories. Coordinates are in Angstrom
throughout (PDB native units). The files written are byte for byte the JAX
package's, header included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_SOLVENT_RESNAMES = {
    "HOH", "SOL", "WAT", "TIP", "TIP3", "TIP4", "T3P", "T4P",
    "NA", "CL", "NA+", "CL-", "K", "K+", "MG", "CA2",
}


@dataclass(frozen=True)
class Atom:
    name: str
    resname: str
    resseq: int
    chain: str
    element: str


@dataclass
class Topology:
    """Atom list + residue bookkeeping for a (CG) molecule."""

    atoms: List[Atom]

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    @property
    def n_residues(self) -> int:
        return len({(a.chain, a.resseq, a.resname) for a in self.atoms})

    def subset(self, indices: Sequence[int]) -> "Topology":
        return Topology([self.atoms[i] for i in indices])

    def ca_indices(self) -> np.ndarray:
        """Indices of C-alpha atoms — reproduces the reference's
        ``'CA' in str(atom)`` mdtraj filter (evaluate/evaluators.py:866-868)."""
        return np.array(
            [i for i, a in enumerate(self.atoms) if "CA" in a.name], dtype=np.int64
        )


@dataclass
class Structure:
    """A topology plus one frame of coordinates in Angstrom."""

    topology: Topology
    xyz: np.ndarray  # (n_atoms, 3) Angstrom

    def atom_slice(self, indices) -> "Structure":
        indices = np.asarray(indices)
        return Structure(self.topology.subset(list(indices)), self.xyz[indices])


def load_pdb(path: str, model: int = 1, remove_solvent: bool = False) -> Structure:
    """Parse the first MODEL's ATOM/HETATM records of a PDB file."""
    atoms: List[Atom] = []
    coords: List[List[float]] = []
    current_model = 1
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec.startswith("MODEL"):
                try:
                    current_model = int(line.split()[1])
                except (IndexError, ValueError):
                    current_model = 1
                continue
            if rec.startswith("ENDMDL") and current_model >= model:
                break
            if current_model != model:
                continue
            if rec not in ("ATOM  ", "HETATM"):
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            name = line[12:16].strip()
            resname = line[17:21].strip()
            if remove_solvent and resname in _SOLVENT_RESNAMES:
                continue
            chain = line[21]
            try:
                resseq = int(line[22:26])
            except ValueError:
                # Some CG exports use hybrid resseq like " 10A"; strip alpha.
                resseq = int("".join(c for c in line[22:27] if c.isdigit()))
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            element = line[76:78].strip() if len(line) >= 78 else name[:1]
            atoms.append(Atom(name, resname, resseq, chain, element or name[:1]))
            coords.append([x, y, z])
    return Structure(Topology(atoms), np.asarray(coords, dtype=np.float32))


def process_pdb(pdb_path: str, mol_name: str) -> Structure:
    """Slice C-alpha beads from a fine-grained folded PDB.

    Equivalent of reference evaluate/evaluators.py:861-871, including the
    protein_g special case (CA atoms [5:61]).
    """
    full = load_pdb(pdb_path, remove_solvent=True)
    ind_ca = full.topology.ca_indices()
    if mol_name.upper() == "PROTEIN_G":
        ind_ca = ind_ca[5:61]
    return full.atom_slice(ind_ca)


def save_pdb(path: str, xyz: np.ndarray, topology: Topology) -> None:
    """Write a multi-frame CG trajectory as a PDB file (Angstrom).

    Matches the file produced by the reference's mdtraj export
    (utils.py:215-218, sample.py:242-247): mdtraj stores nm (coords / 10) and
    its PDB writer re-emits Angstrom, so values round-trip unchanged.
    """
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    n_frames, n_atoms, _ = xyz.shape
    assert n_atoms == topology.n_atoms, "topology/coordinate mismatch"
    with open(path, "w") as f:
        f.write("REMARK   GENERATED BY twoforone_tpu\n")
        for frame in range(n_frames):
            f.write(f"MODEL     {frame + 1:4d}\n")
            for i, a in enumerate(topology.atoms):
                x, y, z = xyz[frame, i]
                # PDB columns (0-indexed): 6-10 serial, 12-15 name, 16 altLoc,
                # 17-20 resName, 21 chain, 22-25 resSeq, 26 iCode, 30- coords.
                name4 = a.name if len(a.name) >= 4 else f" {a.name:<3s}"
                f.write(
                    f"ATOM  {i + 1:5d} {name4:<4.4s} {a.resname:<4.4s}"
                    f"{a.chain if a.chain.strip() else 'A'}{a.resseq:4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {a.element:>2s}\n"
                )
            f.write("TER\nENDMDL\n")
        f.write("END\n")
