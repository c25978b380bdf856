"""Evaluation (port of ``twoforone_tpu/evaluate/evaluators.py``): the
orchestrating :class:`Evaluator` with the three evaluators it builds
(dihedral JS for alanine dipeptide, TIC JS and PWD JS for the fast folders),
the RMSD-to-native and contact-map evaluators, and batched sampling
(``sample_from_model``).

The metrics are numpy, over the port's torch geometry in float32, as the JAX
package computes them; golden references load from the staged assets by
path. The JAX package's repairs of the reference are kept: ``TicEvaluator``
returns ``None`` for the figure when it does not plot, the PWD plot computes
its ground-truth distances where it needs them, ``np.histogram2d`` takes
``density=True``, an empty ``evalsetname`` means ``"testset"``, and a fast
folder without data or a golden TICA pickle is scored on PWD alone.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from twoforone_torch.data.molecules import FOLDED_PDB_DIR, SAVED_REFERENCES_DIR, Molecules
from twoforone_torch.data.pdb import process_pdb
from twoforone_torch.evaluate.deeptime_compat import load_pwd_reference, load_tica_reference
from twoforone_torch.evaluate.metrics import (
    free_energy_mse,
    get_prob,
    get_torsions,
    js_divergence,
    kl_div_density,
)
from twoforone_torch.evaluate.tica import fit_tica
from twoforone_torch.ops.geometry import (
    dihedrals,
    kabsch_rmsd,
    pairwise_distances,
    pwd_triu_batch,
    sliding_dihedral_indices,
)


def _as_coords(data) -> Optional[np.ndarray]:
    """Accept CGDataset / array-like; return (frames, N, 3) numpy or None."""
    if data is None:
        return None
    if hasattr(data, "is_empty"):
        return None if data.is_empty else np.asarray(data.data)
    arr = np.asarray(data)
    return arr if arr.size else None


def _f32(xyz) -> torch.Tensor:
    return torch.as_tensor(np.asarray(xyz, dtype=np.float32))


def _pwd_triu(xyz, offset: int = 1) -> np.ndarray:
    return pwd_triu_batch(_f32(xyz), offset).numpy()


class Evaluator:
    """Orchestrating evaluator used in training and the main evaluation.

    Dispatch per molecule: alanine dipeptide -> dihedral JS; fast folders ->
    TIC JS + PWD JS; protein_g -> neither.
    """

    def __init__(
        self,
        ref_data,
        topology,
        mol_name: str = "alanine",
        eval_folder: Optional[str] = None,
        folded_pdb_folder: str = FOLDED_PDB_DIR,
        data_folder: Optional[str] = None,
        evalsetname: str = "",
    ):
        self.ref_data = _as_coords(ref_data)
        self.topology = topology
        self.eval_folder = eval_folder
        self.folded_pdb_folder = folded_pdb_folder
        self.mol_name = mol_name

        evalset = evalsetname or "testset"
        self.tic = None
        if "alanine" in mol_name:
            self.dihedral_evaluator = DihedralEnergiesEvaluator(
                self.ref_data, topology, self.eval_folder
            )
        elif mol_name.lower() != "protein_g":
            try:
                self.tic = TicEvaluator(
                    self.ref_data,
                    mol_name,
                    eval_folder=self.eval_folder,
                    data_folder=data_folder,
                    folded_pdb_folder=folded_pdb_folder,
                    evalset=evalset,
                )
            except ValueError:
                # A fast folder with neither data nor a golden TICA pickle
                # (they are staged for chignolin and trp_cage only): no TIC
                # metric; PWD still runs on its offset-3 golden pickle.
                if self.ref_data is not None:
                    raise
                print(
                    f"Evaluator: no reference data and no golden TICA pickle "
                    f"for {mol_name}; skipping the TIC metric (PWD only)"
                )
        if mol_name.lower() != "protein_g":
            self.pwd_evaluator = PwdEvaluator(
                self.ref_data, self.eval_folder, mol_name, evalset=evalset
            )

    def eval(self, sampled_mol, milestone, save_plots: bool = False) -> dict:
        sampled_mol = np.asarray(sampled_mol)
        dict_results = {}
        if "alanine" in self.mol_name:
            print(f"Dihedral analysis {milestone}")
            _, dihedral_js, _, _ = self.dihedral_evaluator.eval(
                sampled_mol, save_plots, milestone
            )
            dict_results["Dihedral JS"] = dihedral_js
        elif self.tic is not None:
            print(f"TIC analysis {milestone}")
            dict_results["TIC JS"] = self.tic.eval(
                sampled_mol, title=f"tic_{milestone}", plot_tic=save_plots
            )[0]
        if self.mol_name.lower() != "protein_g":
            print(f"PWD Analysis {milestone}")
            dict_results["PWD JS"] = self.pwd_evaluator.eval(sampled_mol)

        for key in dict_results:
            print(key + f": {dict_results[key]:.4f}")
        if self.eval_folder is not None:
            with open(os.path.join(self.eval_folder, f"results-{milestone}.json"), "w") as f:
                json.dump(dict_results, f)
        print("Evaluation done \n")
        return dict_results


class DihedralEnergiesEvaluator:
    """Dihedral (Ramachandran) free-energy evaluator for alanine dipeptide."""

    def __init__(
        self,
        val_data=None,
        topology=None,
        plots_folder: Optional[str] = None,
        n_bins: int = 61,
        saved_ref: Optional[str] = None,
    ):
        self.topology = topology
        self.plots_folder = plots_folder
        self.n_bins = n_bins
        if saved_ref is None:
            saved_ref = os.path.join(SAVED_REFERENCES_DIR, "saved_dih_probs_ala2_testset.pickle")
        val_data = _as_coords(val_data)
        if val_data is not None:
            self.gt_probs = get_prob(get_torsions(val_data), n_bins=self.n_bins)
        elif os.path.exists(saved_ref):
            with open(saved_ref, "rb") as f:
                self.gt_probs = pickle.load(f)
        else:
            raise ValueError("DihedralEnergiesEvaluator needs reference data or a golden pickle")

    def eval(self, all_mol, plot_freeE=False, milestone=0,
             plot_title="Ramachandran plot", save_plot=True):
        probs = get_prob(get_torsions(np.asarray(all_mol)), n_bins=self.n_bins)
        dihedral_mse = free_energy_mse(probs, self.gt_probs)
        dihedral_js = js_divergence(probs, self.gt_probs)
        kl_1 = kl_div_density(probs, self.gt_probs)
        kl_2 = kl_div_density(self.gt_probs, probs)
        if plot_freeE and self.plots_folder is not None:
            from twoforone_torch.evaluate.plots import plot_free_energy_2d

            plot_free_energy_2d(
                probs,
                os.path.join(self.plots_folder, f"ramachandran_sampled_{milestone}.png"),
                self.n_bins, plot_title, save_plot,
            )
            plot_free_energy_2d(
                self.gt_probs, os.path.join(self.plots_folder, "ramachandran_valid.png"),
                self.n_bins, plot_title, save_plot,
            )
        return dihedral_mse, dihedral_js, kl_1, kl_2


class PwdEvaluator:
    """Per-pair pairwise-distance histogram JS. Histograms use 0.1 Angstrom
    resolution with per-pair ranges set by the ground-truth maxima."""

    def __init__(
        self,
        val_data=None,
        plots_folder: str = "",
        mol_name: str = "",
        offset: int = 0,
        saved_ref: str = "none",
        evalset: str = "testset",
    ):
        self.offset = offset
        self.plots_folder = plots_folder
        self.mol_name = mol_name.lower()
        self.resolution = 0.1
        self.gt_pwd_triu = None

        defaulted_ref = saved_ref == "none"
        if defaulted_ref:
            saved_ref = os.path.join(
                SAVED_REFERENCES_DIR,
                f"saved_pwd_{mol_name.upper()}_{evalset}_offset_{self.offset}.pickle",
            )

        val_data = _as_coords(val_data)
        if val_data is not None:
            self.gt_pwd_triu = _pwd_triu(val_data, self.offset)
            self.gt_max = self.gt_pwd_triu.max(axis=0)
            self.gt_hist = []
            for pwd, m in zip(self.gt_pwd_triu.T, self.gt_max):
                nbins = int(m // self.resolution + 1)
                hist, _ = np.histogram(pwd, bins=nbins, range=(0, self.resolution * nbins))
                self.gt_hist.append(hist.astype(np.float64))
        else:
            # Without data the golden pickles are the reference; they are
            # staged at offset 3 only. An explicitly named pickle that is
            # absent is the caller's error; the default construction (offset
            # 0, no name) falls back to the offset-3 pickle and scores the
            # same pair set.
            if not os.path.exists(saved_ref) and not defaulted_ref:
                raise FileNotFoundError(
                    f"PwdEvaluator: explicit saved_ref does not exist: {saved_ref}"
                )
            if not os.path.exists(saved_ref) and defaulted_ref and self.offset == 0 and mol_name:
                fallback = os.path.join(
                    SAVED_REFERENCES_DIR,
                    f"saved_pwd_{mol_name.upper()}_{evalset}_offset_3.pickle",
                )
                if os.path.exists(fallback):
                    print(
                        f"PwdEvaluator: no reference data and no offset-{self.offset} golden "
                        f"pickle; falling back to the staged offset-3 pickle "
                        f"{os.path.basename(fallback)}"
                    )
                    self.offset = 3
                    saved_ref = fallback
            if os.path.exists(saved_ref):
                self.gt_max, self.gt_hist = load_pwd_reference(saved_ref)
            else:
                raise ValueError("PwdEvaluator needs reference data or a golden pickle")

    def js_divergence_pwd(self, hist_gt, pwd_sampled, gt_max, resolution) -> float:
        if pwd_sampled.shape[1] != len(hist_gt):
            raise ValueError(
                f"PWD pair-count mismatch: samples have {pwd_sampled.shape[1]} "
                f"offset-{self.offset} pairs but the reference histograms have "
                f"{len(hist_gt)}: bead count of the samples does not match "
                f"the reference for '{self.mol_name}'"
            )
        result_js = np.empty(len(hist_gt))
        for i, (hgt, pwd, gtm) in enumerate(zip(hist_gt, pwd_sampled.T, gt_max)):
            maxval = max(float(gtm), float(pwd.max()))
            nbins = int(maxval // resolution + 1)
            hist_sampled, _ = np.histogram(pwd, bins=nbins, range=(0, resolution * nbins))
            hgt = np.asarray(hgt, dtype=np.float64)
            if nbins > len(hgt):
                hgt = np.concatenate([hgt, np.zeros(nbins - len(hgt))])
            result_js[i] = js_divergence(hgt, hist_sampled)
        return float(result_js.mean())

    def eval(self, all_mol, plot_pwds=False, milestone=0) -> float:
        pwd_sampled = _pwd_triu(all_mol, self.offset)
        pwd_js = self.js_divergence_pwd(self.gt_hist, pwd_sampled, self.gt_max, self.resolution)
        if plot_pwds:
            from twoforone_torch.evaluate.plots import plot_pwd_histograms

            assert self.gt_pwd_triu is not None, (
                "PWD histogram plot requires reference data (not just golden histograms)"
            )
            assert self.offset == 1, "Offset needs to be set to 1 for this plot"
            plot_pwd_histograms(
                self.gt_pwd_triu,
                pwd_sampled,
                os.path.join(self.plots_folder, f"PWDS_{self.mol_name}_DM_{milestone}.png"),
            )
        return pwd_js


class TicEvaluator:
    """TICA free-energy-surface JS for fast folders. Features = sliding
    4-mer dihedrals + upper-triangle pairwise distances; TICA(lagtime=100,
    dim=2)."""

    def __init__(
        self,
        val_data=None,
        mol_name: str = "",
        eval_folder: Optional[str] = None,
        data_folder: Optional[str] = None,
        folded_pdb_folder: str = FOLDED_PDB_DIR,
        bins: int = 101,
        saved_ref: str = "none",
        evalset: str = "testset",
    ):
        self.mol_name = mol_name
        self.plots_folder = eval_folder
        self.bins = bins
        protid = Molecules[mol_name.upper()].value
        self.folded = process_pdb(os.path.join(folded_pdb_folder, f"{protid}.pdb"), mol_name)

        if saved_ref == "none":
            saved_ref = os.path.join(
                SAVED_REFERENCES_DIR, f"saved_TICA_{mol_name.upper()}_{evalset}.pickle"
            )

        if os.path.exists(saved_ref):
            (self.tica, self.gt_prob, self.bin_edges_x, self.bin_edges_y) = (
                load_tica_reference(saved_ref)
            )
        else:
            val_coords = _as_coords(val_data)
            if val_coords is None or data_folder is None:
                raise ValueError(
                    "TicEvaluator needs a golden pickle or (val data + data_folder)"
                )
            from twoforone_torch.data.datasets import get_dataset

            trainset, valset, testset = get_dataset(
                mol_name, mean0=True, data_folder=data_folder, shuffle_before_splitting=False,
            )
            sorted_xyz = np.concatenate([trainset.data, valset.data, testset.data], axis=0)
            # TIC eigenvalues fit on the full time-ordered trajectory.
            self.tica = fit_tica(self.get_tic_features(sorted_xyz), lagtime=100, dim=2)
            transformed = self.tica(self.get_tic_features(val_coords))
            self.gt_prob, self.bin_edges_x, self.bin_edges_y = np.histogram2d(
                transformed[:, 0], transformed[:, 1], bins=self.bins, density=True
            )

        self.bin_mids_x = (self.bin_edges_x[1:] + self.bin_edges_x[:-1]) / 2
        self.bin_mids_y = (self.bin_edges_y[1:] + self.bin_edges_y[:-1]) / 2
        folded_transform = self.tica(self.get_tic_features(self.folded.xyz[None]))[0]
        self.bin_x_folded = int(np.argmin(abs(self.bin_mids_x - folded_transform[0])))
        self.bin_y_folded = int(np.argmin(abs(self.bin_mids_y - folded_transform[1])))

    def get_tic_features(self, xyz) -> np.ndarray:
        """Dihedrals over sliding 4-mers + PWD triu."""
        x = _f32(xyz)
        dihe = dihedrals(x, sliding_dihedral_indices(x.shape[1])).numpy()
        return np.hstack((dihe, pwd_triu_batch(x).numpy()))

    def eval(self, xyz_samples, title="", plot_tic=True, path=None, cmap="OrRd",
             gradient=True, steps=3, linewidth=2):
        transformed = self.tica(self.get_tic_features(np.asarray(xyz_samples)))
        prob_samp, _, _ = np.histogram2d(
            transformed[:, 0], transformed[:, 1],
            bins=[self.bin_edges_x, self.bin_edges_y], density=True,
        )
        tic_js = js_divergence(self.gt_prob.flatten(), prob_samp.flatten())

        fig = None
        if plot_tic and self.plots_folder is not None:
            from twoforone_torch.evaluate.plots import plot_tic_map

            file_name = os.path.join(
                self.plots_folder,
                f"TICA_{self.mol_name}_{title}{'_path' if path is not None else ''}.png",
            )
            fig = plot_tic_map(
                prob_samp, self.bin_mids_x, self.bin_mids_y,
                self.bin_x_folded, self.bin_y_folded, title, file_name,
                path=path, cmap=cmap, gradient=gradient, steps=steps, linewidth=linewidth,
            )
        return tic_js, fig


class RmsdEvaluator:
    """RMSD-to-native free-energy evaluator: a histogram of each frame's
    Kabsch RMSD to the folded structure, as -log density."""

    cutoff_dict_ref = {
        "chignolin": 10,
        "trp_cage": 12,
        "bba": 14,
        "villin": 14,
        "protein_g": 20,
    }

    def __init__(self, mol_name: str, folded_pdb: Optional[str] = None,
                 eval_folder: Optional[str] = None):
        self.plots_folder = eval_folder
        if folded_pdb is None:
            protid = Molecules[mol_name.upper()].value
            folded_pdb = os.path.join(FOLDED_PDB_DIR, f"{protid}.pdb")
        self.folded = process_pdb(folded_pdb, mol_name)
        self.plot_dict = {}
        self.mol_name = mol_name
        self.saved_ref = os.path.join(
            SAVED_REFERENCES_DIR, f"saved_rmsd_{self.mol_name.upper()}_reference_total.pickle"
        )
        self.cutoff_ref = self.cutoff_dict_ref[mol_name.lower()]
        self.nbins_ref = 100

    def eval(self, method: str, xyz=None, nbins: int = 100,
             cutoff: Optional[float] = None, save_dynamics: bool = False):
        """``method="Reference"`` without frames loads the staged reference
        curve (it exists for 100 bins and the molecule's cutoff only);
        otherwise frames that are not finite get RMSD nan and stay out of
        the histogram."""
        if method == "Reference" and xyz is None and os.path.exists(self.saved_ref):
            assert nbins == self.nbins_ref and cutoff == self.cutoff_ref, (
                f"Reference data only exists for nbins={self.nbins_ref} and "
                f"cutoff={self.cutoff_ref}"
            )
            with open(self.saved_ref, "rb") as f:
                self.plot_dict[method] = pickle.load(f)
            return self.plot_dict[method]

        xyz = np.asarray(xyz)
        self.plot_dict[method] = {}
        valid_mask = np.all(np.all(np.isfinite(xyz), -1), -1)
        rmsd = np.full(len(xyz), np.nan)
        rmsd[valid_mask] = kabsch_rmsd(_f32(xyz[valid_mask]), _f32(self.folded.xyz)).numpy()
        if save_dynamics:
            self.plot_dict[method]["rmsd"] = rmsd
        if cutoff is None:
            cutoff = rmsd[~np.isnan(rmsd)].max()
        h, bin_edges = np.histogram(rmsd, bins=nbins, range=[0, cutoff], density=True)
        self.plot_dict[method]["bin_mids"] = (bin_edges[:-1] + bin_edges[1:]) / 2.0
        with np.errstate(divide="ignore"):
            self.plot_dict[method]["energies"] = -np.log(h)
        return self.plot_dict[method]

    def plot(self, save=True, **kwargs):
        from twoforone_torch.evaluate.plots import plot_rmsd_free_energy

        return plot_rmsd_free_energy(
            self.plot_dict, self.mol_name, self.plots_folder, save=save, **kwargs
        )


class ContactEvaluator:
    """Contact-map evaluator: contacts = pairwise distance < cutoff (default
    10 Angstrom). Distances are computed in the frames' floating type
    (float32 frames: float32, as the JAX package computes them)."""

    def __init__(self, mol_name: str, folded_pdb: Optional[str] = None,
                 eval_folder: Optional[str] = None, contact_cutoff: float = 10):
        self.mol_name = mol_name
        self.contact_cutoff = contact_cutoff
        self.plots_folder = eval_folder
        if folded_pdb is None:
            protid = Molecules[mol_name.upper()].value
            folded_pdb = os.path.join(FOLDED_PDB_DIR, f"{protid}.pdb")
        self.folded = process_pdb(folded_pdb, mol_name).xyz
        self.pwd_folded = pairwise_distances(torch.as_tensor(self.folded)).numpy()
        self.contacts_folded = self.pwd_folded < self.contact_cutoff

    def get_contacts(self, xyz_sampled) -> np.ndarray:
        pwd = pairwise_distances(torch.as_tensor(np.asarray(xyz_sampled))).numpy()
        return pwd < self.contact_cutoff

    def normalized_contact_count(self, xyz_sampled) -> np.ndarray:
        contacts = self.get_contacts(xyz_sampled)
        return contacts.sum(axis=0) / len(contacts)

    def bce_dynamics(self, xyz_sampled) -> np.ndarray:
        """Per-frame binary cross entropy to the folded contact map over the
        pairs at least 3 apart, with ``torch.nn.functional.binary_cross_entropy``'s
        clamp of the logs at -100."""
        contacts = self.get_contacts(xyz_sampled).astype(np.float64)
        n = self.contacts_folded.shape[-1]
        iu, ju = np.triu_indices(n, k=3)
        samp = contacts[:, iu, ju]
        target = self.contacts_folded[iu, ju].astype(np.float64)
        with np.errstate(divide="ignore"):
            log_p = np.maximum(np.log(samp), -100.0)
            log_1mp = np.maximum(np.log(1.0 - samp), -100.0)
        bce = -(target * log_p + (1.0 - target) * log_1mp)
        return bce.mean(axis=-1)

    def eval_bce(self, xyz_sampled) -> float:
        return float(self.bce_dynamics(xyz_sampled).mean())

    def plot_contact_normcount(self, xyz_sampled, method, save=True,
                               take_log=False, vmin_log=None):
        from twoforone_torch.evaluate.plots import plot_contact_normcount

        norm_sum = self.normalized_contact_count(xyz_sampled)
        return plot_contact_normcount(
            norm_sum, self.mol_name, method, self.plots_folder,
            save=save, take_log=take_log, vmin_log=vmin_log,
        )


def num_to_groups(num: int, divisor: int):
    """[divisor] * (num // divisor) + optional remainder."""
    groups, remainder = divmod(num, divisor)
    arr = [divisor] * groups
    if remainder > 0:
        arr.append(remainder)
    return arr


def sample_from_model(sample_fn, num_saved_samples: int, batch_size: int,
                      generator: torch.Generator, verbose: bool = False) -> np.ndarray:
    """Draw ``num_saved_samples`` samples in batches and concatenate them on
    the host: (num_saved_samples, N, 3) numpy float32.

    ``sample_fn(batch_size, generator) -> (batch, N, 3)``; every batch draws
    from the one ``generator``, which lives on the run's device. The
    remainder batch samples a full batch and is truncated, so the sampler
    sees one batch shape: a CUDA graph (the clx force evaluation) is
    captured, and keeps its memory pool, once per shape.
    """
    print(f"Generating {num_saved_samples} samples. This may take some time.")
    batches = num_to_groups(num_saved_samples, batch_size)
    out = []
    last_print = time.monotonic()
    for i, b in enumerate(batches):
        full = sample_fn(batch_size, generator)
        out.append(full[:b].cpu().numpy())
        if verbose or time.monotonic() - last_print > 60.0:
            print(f"Batch {i + 1} from {len(batches)} generated", flush=True)
            last_print = time.monotonic()
    all_mol = np.concatenate(out, axis=0)
    print(f"{len(all_mol)} samples generated")
    return all_mol
