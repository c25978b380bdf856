"""Dataset layer: numpy-backed CG coordinate datasets (copy of
``twoforone_tpu/data/datasets.py``).

- per-molecule normalization stds and bead one-hots,
- alanine dipeptide: four-fold cross-validation chunks with a 500k train cap,
- D.E. Shaw fast folders: nm -> Angstrom, the fixed-seed shuffle and the
  sequential 70/10/20 split,
- the "empty dataset" mode (``data_folder=None``): topology, std and one-hot
  only, so a model samples without its training data.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules, norm_stds
from twoforone_torch.data.pdb import Topology, load_pdb

SHUFFLE_SEED = 2342361  # fixed shuffle seed, reference dataset_utils_empty.py:234


def to_angstrom(x: np.ndarray) -> np.ndarray:
    """nm -> Angstrom (reference dataset_utils_empty.py:175-179)."""
    return x * 10.0


@dataclass
class CGDataset:
    """Coarse-grained conformations of one molecule.

    ``data`` is (n_frames, num_beads, 3) float32 in Angstrom, already
    mean-centered when ``mean0``; ``None`` in empty mode.
    """

    data: Optional[np.ndarray]
    topology: Topology
    molecule: object  # Molecules member or "alanine_foldK" string
    mean0: bool = True

    def __post_init__(self):
        self.std = norm_stds[self.molecule]
        if isinstance(self.molecule, Molecules):
            self.num_beads = self.topology.n_residues
        elif "alanine" in str(self.molecule).lower():
            self.num_beads = 5
        else:
            raise NotImplementedError("Invalid molecule name")
        self.bead_onehot = np.eye(self.num_beads, dtype=np.float32)

    def __len__(self) -> int:
        return 0 if self.data is None else len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    @property
    def is_empty(self) -> bool:
        return self.data is None

    def get_subset(self, indices) -> "CGDataset":
        assert self.data is not None
        return replace(self, data=self.data[np.asarray(indices)])

    @staticmethod
    def prepare(data: np.ndarray, mean0: bool, shuffle: bool) -> np.ndarray:
        data = np.asarray(data, dtype=np.float32)
        if mean0:
            data = data - data.mean(axis=1, keepdims=True)
        if shuffle:
            rng_state = np.random.get_state()
            np.random.seed(SHUFFLE_SEED)
            np.random.shuffle(data)
            np.random.set_state(rng_state)
        return data


def _load_ala2_coords(data_folder: str) -> np.ndarray:
    npz_file = os.path.join(data_folder, "ala2_cg_2fs_Hmass_2_HBonds.npz")
    return np.load(npz_file)["coords"]


def _load_deshaw_coords(data_folder: str, molecule: Molecules) -> np.ndarray:
    """Load a fast-folder CG trajectory.

    Two sources are supported:
    1. A preprocessed array ``{PROTID}-0-c-alpha.np[yz]`` in ``data_folder``
       (coordinates in nm, as exported by mdtraj): one mmap-able blob
       instead of thousands of trajectory parts.
    2. The original csv-indexed mdtraj layout
       (``{PROTID}/simulation_0/c-alpha/...``), which requires the optional
       ``mdtraj`` dependency (reference dataset_utils_empty.py:393-442).
    """
    protid = molecule.value
    for ext in (".npy", ".npz"):
        p = os.path.join(data_folder, f"{protid}-0-c-alpha{ext}")
        if os.path.exists(p):
            arr = np.load(p, mmap_mode="r" if ext == ".npy" else None)
            if ext == ".npz":
                arr = arr["coords"]
            return to_angstrom(np.asarray(arr, dtype=np.float32))

    sim_path = os.path.join(data_folder, protid, "simulation_0", "c-alpha")
    full_id = f"{protid}-0-c-alpha"
    csv_path = os.path.join(sim_path, full_id, f"{full_id}_times.csv")
    if os.path.exists(csv_path):
        try:
            import mdtraj as md  # optional dependency
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "Raw D.E. Shaw trajectory layout requires mdtraj; either install "
                "it or preprocess to a single {PROTID}-0-c-alpha.npy (nm) file."
            ) from e
        import csv

        with open(csv_path) as f:
            files = [row[1] for row in csv.reader(f)]
        traj = md.load(
            [os.path.join(sim_path, full_id, t) for t in files],
            top=os.path.join(sim_path, full_id, f"{full_id}.pdb"),
        )
        return to_angstrom(np.asarray(traj.xyz, dtype=np.float32))

    raise FileNotFoundError(
        f"No data for {molecule.name} under {data_folder}: expected "
        f"{protid}-0-c-alpha.npy/.npz or the csv-indexed trajectory layout"
    )


def get_dataset(
    mol: str,
    mean0: bool,
    data_folder: Optional[str] = None,
    fold: Optional[int] = None,
    traindata_subset: Optional[int] = None,
    shuffle_before_splitting: bool = False,
    pdb_folder: Optional[str] = None,
    ala2_train_cap: int = 500000,
    split_seed: Optional[int] = SHUFFLE_SEED,
):
    """Build (trainset, valset, testset) for a molecule.

    Mirrors reference get_dataset (dataset_utils_empty.py:51-172); with
    ``data_folder=None`` all three are the same empty dataset carrying only
    topology/std/one-hot.
    """
    if pdb_folder is None:
        pdb_folder = FOLDED_PDB_DIR

    if mol.lower() == "alanine_dipeptide_fuberlin":
        assert fold is not None and fold in (1, 2, 3, 4), "Please supply a fold in [1,2,3,4]"
        topology = load_pdb(os.path.join(pdb_folder, "ala2_cg.pdb")).topology
        molecule = f"alanine_fold{fold}"
        if data_folder is None:
            empty = CGDataset(None, topology, molecule, mean0)
            return empty, empty, empty
        assert not shuffle_before_splitting, (
            f"Shuffling data before split not supported for dataset {mol}."
        )
        coords = CGDataset.prepare(_load_ala2_coords(data_folder), mean0, shuffle=False)
        dataset = CGDataset(coords, topology, molecule, mean0)

        # 4-fold chunking: test = fold's chunk; trainval = rest, shuffled;
        # train capped at 500k (reference dataset_utils_empty.py:88-113).
        # Chunk boundaries reproduce torch.chunk: every chunk ceil(n/4)
        # except a short last one (np.array_split pads the FIRST chunks
        # instead, so fold membership would diverge whenever n % 4 != 0).
        n = len(dataset)
        chunk_size = -(-n // 4)
        chunks = [np.arange(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
        while len(chunks) < 4:  # degenerate tiny datasets
            chunks.append(np.array([], dtype=np.int64))
        testrange = chunks[fold - 1]
        trainval = np.concatenate(chunks[: fold - 1] + chunks[fold:])
        # The reference shuffles with UNSEEDED torch.randperm
        # (dataset_utils_empty.py:96), so its split differs per process; a
        # reproducible framework seeds it. split_seed=None restores the
        # legacy nondeterministic behavior.
        if split_seed is not None:
            perm = np.random.default_rng(split_seed).permutation(len(trainval))
        else:
            perm = np.random.permutation(len(trainval))
        trainval = trainval[perm]
        trainrange = trainval[:ala2_train_cap]
        valrange = trainval[ala2_train_cap:]
        if traindata_subset is not None:
            assert (
                isinstance(traindata_subset, int)
                and traindata_subset > 0
                and len(trainrange) >= traindata_subset
            ), "Provide valid number of points for subset"
            trainrange = trainrange[:traindata_subset]
        return (
            dataset.get_subset(trainrange),
            dataset.get_subset(valrange),
            dataset.get_subset(testrange),
        )

    if "alanine_dipeptide" in mol.lower():
        raise ValueError(
            f"Wrong dataset mol/dataset name {mol}. Use alanine_dipeptide_fuberlin."
        )

    # D.E. Shaw fast-folding proteins
    if fold is not None:
        warnings.warn("Fold not implemented for this dataset")
    if traindata_subset is not None:
        warnings.warn(
            "Traindata subset is not implemented for this molecule. Ignoring this argument"
        )
    molecule = Molecules[mol.upper()]
    pdb_file = os.path.join(pdb_folder, f"{molecule.value}-0-c-alpha.pdb")
    topology = load_pdb(pdb_file).topology

    if data_folder is None:
        empty = CGDataset(None, topology, molecule, mean0)
        return empty, empty, empty

    coords = CGDataset.prepare(
        _load_deshaw_coords(data_folder, molecule), mean0, shuffle_before_splitting
    )
    dataset = CGDataset(coords, topology, molecule, mean0)

    # Sequential 70/10/20 split (reference dataset_utils_empty.py:151-162).
    n = len(dataset)
    num_val = int(np.floor(0.1 * n))
    num_test = int(np.floor(0.2 * n))
    num_train = n - num_val - num_test
    idx = np.arange(n)
    return (
        dataset.get_subset(idx[:num_train]),
        dataset.get_subset(idx[num_train : num_train + num_val]),
        dataset.get_subset(idx[num_train + num_val :]),
    )
