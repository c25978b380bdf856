"""Positive control: the whole train -> sample -> evaluate stack must learn
(port of ``twoforone_tpu/train/positive_control.py``).

A diffusion model is trained through the complete :class:`Trainer` path on a
synthetic system with an exactly known torsion distribution
(:mod:`twoforone_torch.data.synthetic`), and the trained model is held to
absolute bars:

- i.i.d. samples (the full reverse chain) must reproduce the generator's
  distribution (dihedral JS for the 5-bead dipeptide analogue; TIC JS and
  pairwise-distance JS for the bead chains at a protein's size);
- Langevin dynamics from the force extracted at noise level t must do the
  same, which holds the score -> force -> BAOAB pipeline end to end; a
  basin-exchange report (:mod:`twoforone_torch.evaluate.ergodicity`) says
  whether single chains cross between the metastable states.

The post-training stages (i.i.d. samples, Langevin) persist their products
as ``post_{name}.npy`` in the results folder, and the Langevin stage runs in
checkpointed segments (:mod:`twoforone_torch.dynamics.segmented`), so that a
run relaunched with ``resume=True`` redoes no finished stage and at most one
segment.

The controls train with ``loss_weights="ones"``: the staged models'
``higheruntil_100`` undersamples the high-noise timesteps that decide basin
membership in the early reverse chain, and caps the i.i.d. dihedral JS; the
Langevin force at low t is trained at the same rate either way.

Differences from the JAX package: every run takes ``device`` (default
``"cuda"``, raising without CUDA), and ``run_positive_control`` takes
``evaluators`` (see there).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.data import synthetic
from twoforone_torch.data.datasets import CGDataset
from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules, default_dt_scale
from twoforone_torch.data.pdb import load_pdb
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.dynamics.segmented import _atomic_save, cleanup, segmented_sample
from twoforone_torch.evaluate.ergodicity import slow_torsion_ergodicity
from twoforone_torch.evaluate.metrics import get_prob, get_torsions, js_divergence
from twoforone_torch.evaluate.tica import fit_tica
from twoforone_torch.models.graph_transformer import GraphTransformer
from twoforone_torch.ops.geometry import dihedrals, pwd_triu_batch, sliding_dihedral_indices
from twoforone_torch.train.trainer import Trainer
from twoforone_torch.utils.config import TrainConfig
from twoforone_torch.utils.device import resolve_device
from twoforone_torch.utils.preempt import exit_if_preempted


def _cached_stage(results_folder, name, compute, resume):
    """A post-training stage whose product persists as
    ``results_folder/post_{name}.npy``; with ``resume`` an existing file is
    loaded and ``compute`` is not called.

    ``name`` must encode every knob that defines the stage's output (the
    Langevin stage is ``langevin_t{t}_dt{scale}_s{steps}``): the cache is
    keyed by file name, so a knob left out would let a resumed run reuse a
    trajectory made at other settings. A stage boundary is also a lossless
    preemption point (:mod:`twoforone_torch.utils.preempt`).
    """
    path = os.path.join(results_folder, f"post_{name}.npy")
    if resume and os.path.exists(path):
        print(f"post-train stage '{name}': loaded from {path}")
        return np.load(path)
    exit_if_preempted(f"post-train stage '{name}'")
    arr = np.asarray(compute())
    _atomic_save(path, arr)
    return arr


def _segmented_langevin_stage(ld, results_folder, name, resume, segment_steps=None):
    """The Langevin stage under the :func:`_cached_stage` contract
    (``post_{name}.npy``), driven in checkpointed segments: a crash or a
    preemption mid-stage costs one segment, not the stage. The segment and
    state files are removed once the stage's product is saved."""
    path = os.path.join(results_folder, f"post_{name}.npy")
    if resume and os.path.exists(path):
        print(f"post-train stage '{name}': loaded from {path}")
        return np.load(path)
    arr = segmented_sample(ld, results_folder, name, segment_steps=segment_steps, resume=resume)
    _atomic_save(path, arr)
    cleanup(results_folder, name)
    return arr


def dihedral_js(coords_a, coords_b, n_bins: int = 61) -> float:
    """JS between the 2D phi/psi histograms of two conformation sets."""
    pa = get_prob(get_torsions(coords_a), n_bins=n_bins)
    pb = get_prob(get_torsions(coords_b), n_bins=n_bins)
    return float(js_divergence(pa, pb))


def pwd_js(coords_a, coords_b, n_bins: int = 100) -> float:
    """JS between pooled pairwise-distance histograms (1D)."""

    def pwd(c):
        c = np.asarray(c)
        d = np.linalg.norm(c[:, :, None, :] - c[:, None, :, :], axis=-1)
        iu = np.triu_indices(c.shape[1], k=1)
        return d[:, iu[0], iu[1]].ravel()

    da, db = pwd(coords_a), pwd(coords_b)
    lo, hi = 0.0, max(da.max(), db.max()) * 1.05
    ha = np.histogram(da, bins=n_bins, range=(lo, hi))[0]
    hb = np.histogram(db, bins=n_bins, range=(lo, hi))[0]
    return float(js_divergence(ha, hb))


def _tic_features(xyz) -> np.ndarray:
    """Sliding 4-mer dihedrals and upper-triangle pairwise distances, in
    float32: the fast folders' TICA features."""
    x = torch.as_tensor(np.asarray(xyz, dtype=np.float32))
    dihe = dihedrals(x, sliding_dihedral_indices(x.shape[1])).numpy()
    return np.hstack((dihe, pwd_triu_batch(x).numpy()))


class SyntheticTicScorer:
    """TIC-JS scoring for the synthetic bead chains, with the TicEvaluator's
    conventions: sliding 4-mer dihedrals + PWD triu features, TICA
    (lagtime 100, dim 2) fit on a reference trajectory, 101-bin 2D density
    histograms, JS on the flattened probabilities."""

    def __init__(self, ref_trajectory, ref_equilibrium, bins: int = 101):
        self.tica = fit_tica(_tic_features(ref_trajectory), lagtime=100, dim=2)
        z = self.tica(_tic_features(ref_equilibrium))
        self.gt_prob, self.ex, self.ey = np.histogram2d(z[:, 0], z[:, 1], bins=bins,
                                                        density=True)

    def tic_js(self, xyz) -> float:
        z = self.tica(_tic_features(xyz))
        prob, _, _ = np.histogram2d(z[:, 0], z[:, 1], bins=[self.ex, self.ey], density=True)
        if not np.isfinite(prob).any() or prob.sum() == 0:
            # Every sample fell outside the reference's bins (a wildly wrong
            # model): the largest divergence, not nan.
            return float(np.log(2))
        return float(js_divergence(self.gt_prob.flatten(), prob.flatten()))


def physics_bars_ok(results: dict) -> bool:
    """The physics contract of a staged chain control
    (``assets/trained/chain{N}/results.json``), as one predicate."""
    return (
        results["nonfinite_frac_iid"] == 0.0
        and results["nonfinite_frac_langevin"] == 0.0
        and results["tic_js_iid"] <= results["tic_js_floor"] + 0.02
        and results["tic_js_langevin"] <= 0.10
        and results["pwd_js_iid"] <= 0.01
        and ergodicity_bars_ok(results)
    )


def ergodicity_bars_ok(results: dict) -> bool:
    """The basin-exchange bar of the staged controls: the measured levels of
    the staged artifacts (chain35: hop 0.153 / occupancy 0.072; chain56:
    0.146 / 0.069), not the report's own ``ergodic`` (hop > 0). Results that
    predate the report carry none of its keys and pass."""
    return (
        results.get("langevin_ergodic", True)
        and results.get("langevin_min_hop_fraction", 1.0) >= 0.10
        and results.get("langevin_max_occupancy_error", 0.0) <= 0.10
    )


#: Per-size chain-control settings: the PDB topology, the Molecules entry,
#: the model shape and optimizer of the published configuration of that
#: protein, and the Langevin noise level and temperature.
CHAIN_CONTROL_PRESETS = {
    10: dict(pdb="CLN025-0-c-alpha.pdb", mol="CHIGNOLIN", hidden_nf=64,
             n_layers=3, learning_rate=4e-4, t_noise=20, temp=340.0,
             n_slow=2, components_seed=None),  # None = CHAIN10 fixture
    20: dict(pdb="2JOF-0-c-alpha.pdb", mol="TRP_CAGE", hidden_nf=128,
             n_layers=3, learning_rate=4e-4, t_noise=15, temp=290.0,
             n_slow=4, components_seed=11),
    # BBA (28 beads): the upper end of the clx force path (CLX_MAX_N = 32).
    28: dict(pdb="1FME-0-c-alpha.pdb", mol="BBA", hidden_nf=96,
             n_layers=3, learning_rate=4e-4, t_noise=5, temp=325.0,
             n_slow=4, components_seed=14),
    # villin (35 beads): where fused="auto" resolves to the plain network.
    35: dict(pdb="2F4K-0-c-alpha.pdb", mol="VILLIN", hidden_nf=128,
             n_layers=3, learning_rate=4e-4, t_noise=5, temp=360.0,
             n_slow=4, components_seed=12),
    # protein G (56 beads, the largest staged system), trained at batch 256.
    56: dict(pdb="NuG2-0-c-alpha.pdb", mol="PROTEIN_G", hidden_nf=128,
             n_layers=3, learning_rate=4e-4, t_noise=5, temp=350.0,
             n_slow=5, components_seed=13, batch_size=256),
}


def chain_control_components(n_beads: int):
    """The torsion mixture of the ``n_beads`` chain control: one tuple of
    (weight, mean, concentration) components per torsion."""
    preset = CHAIN_CONTROL_PRESETS[n_beads]
    if preset["components_seed"] is None:
        return synthetic.CHAIN10_TORSION_COMPONENTS
    return synthetic.make_chain_components(
        n_beads - 3, n_slow=preset["n_slow"], seed=preset["components_seed"]
    )


def chain_control_diffusion(n_beads: int, norm_factor: float, hidden_nf: int = None,
                            n_layers: int = None, timesteps: int = 1000,
                            loss_weights: str = "ones") -> GaussianDiffusion:
    """The chain control's model: the preset's shape (or the given widths),
    production edges (intrinsic coordinates, conservative)."""
    preset = CHAIN_CONTROL_PRESETS[n_beads]
    model = GraphTransformer(
        num_beads=n_beads,
        hidden_nf=preset["hidden_nf"] if hidden_nf is None else hidden_nf,
        n_layers=preset["n_layers"] if n_layers is None else n_layers,
        use_intrinsic_coords=True, use_abs_coords=False,
        use_distances=False, conservative=True,
    )
    return GaussianDiffusion(model=model, num_atoms=n_beads, timesteps=timesteps,
                             norm_factor=norm_factor, loss_weights=loss_weights)


def chain_control_scorer(components, n_data: int, eval_samples: int, seed: int = 0):
    """The chain control's TIC scorer and its floor: TICA fit on an
    independent reference trajectory (at most 200 000 frames, seed + 10),
    the ground-truth histogram from i.i.d. equilibrium draws (seed + 11),
    the floor the TIC JS of another such draw (seed + 12)."""
    scorer = SyntheticTicScorer(
        synthetic.chain_trajectory(min(n_data, 200000), components, seed=seed + 10),
        synthetic.chain_dataset(eval_samples, components, seed=seed + 11),
    )
    floor = scorer.tic_js(synthetic.chain_dataset(eval_samples, components, seed=seed + 12))
    return scorer, floor


def chain_control_langevin(gd, params, init, n_beads: int, steps: int,
                           save_interval: int = 250, t_noise: int = None,
                           dt_scale: float = None, seed: int = 0, fused: str = "never",
                           log: bool = True, device="cuda") -> LangevinDiffusion:
    """The chain control's Langevin run: masses 12, friction 1, the preset's
    temperature, dt from the noise floor times ``dt_scale`` (default: the
    per-protein production value, the one the sampling CLI resolves), at
    noise level ``t_noise`` (default: the preset's)."""
    preset = CHAIN_CONTROL_PRESETS[n_beads]
    t_noise = preset["t_noise"] if t_noise is None else t_noise
    if dt_scale is None:
        dt_scale = default_dt_scale(preset["mol"], n_beads)
    return LangevinDiffusion(
        gd, params, init,
        n_timesteps=steps,
        save_interval=save_interval,
        t=t_noise, temp_data=preset["temp"], temp_sim=preset["temp"],
        dt=None, masses=[12.0] * n_beads, friction=1.0,
        # log=True: a progress line per save interval, so that a launcher
        # watching the log can tell a slow stage from a wedged one.
        kb="consistent", random_seed=seed, log=log, fused=fused,
        dt_scale=dt_scale, device=device,
    )


def run_chain_control(
    n_beads: int = 10,
    train_iter: int = 50000,
    n_data: int = 400000,
    batch_size: int = None,
    hidden_nf: int = None,
    n_layers: int = None,
    learning_rate: float = None,
    num_samples: int = 50000,
    langevin_chains: int = 1000,
    langevin_steps: int = 50000,
    langevin_save_interval: int = 250,
    t_noise: int = None,
    langevin_dt_scale: float = None,
    seed: int = 0,
    results_folder: str = None,
    loss_weights: str = "ones",
    timesteps: int = 1000,
    fused: str = "never",
    eval_samples: int = 50000,
    eval_interval: int = None,
    resume: bool = False,
    device="cuda",
) -> dict:
    """The positive control at a protein's size: the published model shape
    for that protein trained on the synthetic ``n_beads``-bead multi-basin
    chain, scored with the TICA machinery of the fast-folder evaluation. At
    ``n_beads=10`` with ``fused="auto"`` on the card the Langevin stage runs
    the fused force kernel, at 20 the attention-core (clx) path.

    Returns the metric dict the JAX function returns, with the same keys.
    """
    device = resolve_device(device)
    preset = CHAIN_CONTROL_PRESETS[n_beads]
    learning_rate = preset["learning_rate"] if learning_rate is None else learning_rate
    t_noise = preset["t_noise"] if t_noise is None else t_noise
    if langevin_dt_scale is None:
        langevin_dt_scale = default_dt_scale(preset["mol"], n_beads)
    if batch_size is None:
        batch_size = preset.get("batch_size", 512)
    components = chain_control_components(n_beads)

    traj = synthetic.chain_trajectory(n_data, components, seed=seed)
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, preset["pdb"])).topology
    n_train = int(0.7 * n_data)
    n_val = int(0.1 * n_data)
    mol = Molecules[preset["mol"]]
    trainset, valset, testset = (
        CGDataset(part, topology, mol, mean0=True)
        for part in (traj[:n_train], traj[n_train:n_train + n_val], traj[n_train + n_val:])
    )

    if results_folder is None:
        results_folder = tempfile.mkdtemp(prefix=f"chain{n_beads}_control_")

    gd = chain_control_diffusion(n_beads, float(trainset.data.std()), hidden_nf, n_layers,
                                 timesteps, loss_weights)
    cfg = TrainConfig(
        mol=preset["mol"].lower(),
        data_folder=None,
        results_folder=results_folder,
        tensorboard_folder=os.path.join(results_folder, "runs"),
        experiment_name=f"chain{n_beads}_control",
        hidden_features_gnn=gd.model.hidden_nf,
        num_layers_gnn=gd.model.n_layers,
        diffusion_steps=timesteps,
        loss_weights=loss_weights,
        conservative=True,
        use_intrinsic_coords=True,
        use_abs_coords=False,
        use_distances=False,
        batch_size=batch_size,
        learning_rate=learning_rate,
        min_lr_cosine_anneal=1e-5,
        train_iter=train_iter,
        # No evaluation before the end unless asked; long runs pass
        # eval_interval and resume=True, so a crash resumes from the last
        # milestone.
        eval_interval=eval_interval or train_iter,
        start_from_last_saved=resume,
        # One pass over the validation split per evaluation.
        iterations_on_val=1,
        log_tensorboard_interval=500,
        steps_per_host_loop=50,
        num_samples=min(2048, num_samples),
        num_samples_final_eval=min(2048, num_samples),
        eval_langevin=False,
        seed=seed,
    )
    trainer = Trainer(gd, (trainset, valset, testset), preset["mol"].lower(), cfg,
                      use_tensorboard=False, evaluators=False, device=device)
    trainer.train()
    trainer.save("final")

    scorer, floor = chain_control_scorer(components, n_data, eval_samples, seed)

    iid = _cached_stage(results_folder, "iid", lambda: trainer.sample(num_samples), resume)
    finite = np.isfinite(iid).all(axis=(1, 2))
    iid = iid[finite]
    results = {
        "tic_js_floor": floor,
        "tic_js_iid": scorer.tic_js(iid),
        "pwd_js_iid": pwd_js(iid, synthetic.chain_dataset(min(num_samples, 50000), components,
                                                         seed=seed + 13)),
        "nonfinite_frac_iid": float(1.0 - finite.mean()),
        "val_loss": trainer.best_val_loss,
    }

    rng = np.random.default_rng(seed + 3)
    init = iid[rng.integers(0, len(iid), langevin_chains)]
    sim = chain_control_langevin(
        gd, trainer.ema_params(), init, n_beads, langevin_steps, langevin_save_interval,
        t_noise, langevin_dt_scale, seed, fused, device=device,
    )
    # The stage name carries every knob that defines the trajectory (the
    # hop fraction depends on the window's length too).
    traj_lang = _segmented_langevin_stage(
        sim, results_folder, f"langevin_t{t_noise}_dt{langevin_dt_scale:g}_s{langevin_steps}",
        resume,
    )
    finite_l = np.isfinite(traj_lang).all(axis=(1, 2))
    results["nonfinite_frac_langevin"] = float(1.0 - finite_l.mean())
    if finite_l.all():
        # The basin-exchange report on the chain-major trajectory: the
        # stationary TIC JS cannot see frozen chains, which start from
        # i.i.d. samples. Skipped when a frame is not finite (the bars fail
        # then anyway, and nan angles poison the labels).
        erg = slow_torsion_ergodicity(
            traj_lang.reshape(langevin_chains, -1, n_beads, 3), components
        )
        results["langevin_min_hop_fraction"] = erg["min_hop_fraction"]
        results["langevin_max_occupancy_error"] = erg["max_occupancy_error"]
        results["langevin_ergodic"] = erg["ergodic"]
    traj_lang = traj_lang[finite_l]
    results["tic_js_langevin"] = scorer.tic_js(traj_lang)
    results["t_noise_langevin"] = t_noise
    results["langevin_dt_scale"] = langevin_dt_scale
    # The window travels with the window-dependent ergodicity numbers.
    results["langevin_steps"] = langevin_steps
    results["langevin_chains"] = langevin_chains
    results["results_folder"] = results_folder
    return results


def run_chain10_control(**kwargs) -> dict:
    """The chignolin-size (N=10) instance of :func:`run_chain_control`."""
    return run_chain_control(n_beads=10, **kwargs)


#: The configuration of the staged dipeptide-analogue artifact
#: (``assets/trained/ala5/``). Masses 12.8 and 300 K are fixed in
#: :func:`run_positive_control`.
ALA5_CONTROL_PRESET = dict(
    train_iter=80000, n_data=200000, batch_size=1024,
    hidden_nf=64, n_layers=3, learning_rate=6e-4,
    num_samples=40000, langevin_chains=256, langevin_steps=30000,
    langevin_save_interval=100, t_noise=15,
)


def dipeptide_bars_ok(results: dict) -> bool:
    """The physics contract of the staged dipeptide-analogue control
    (``assets/trained/ala5/results.json``): the dihedral-JS counterpart of
    :func:`physics_bars_ok`."""
    return (
        results["nonfinite_frac_iid"] == 0.0
        and results.get("nonfinite_frac_langevin", 1.0) == 0.0
        and results["js_iid"] <= results["js_floor"] + 0.02
        and results["js_langevin_f32"] <= 0.05
        and results["pwd_js_iid"] <= 0.01
        # The bf16 force must be indistinguishable from f32 at the level of
        # the distribution, when the comparison ran.
        and results.get("js_bf16_vs_f32", 0.0) <= 0.02
        and ergodicity_bars_ok(results)
    )


def run_positive_control(
    train_iter: int = 4000,
    n_data: int = 40000,
    batch_size: int = 256,
    hidden_nf: int = 48,
    n_layers: int = 2,
    learning_rate: float = 2e-3,
    num_samples: int = 8192,
    langevin_chains: int = 128,
    langevin_steps: int = 20000,
    langevin_save_interval: int = 100,
    t_noise: int = 15,
    seed: int = 0,
    results_folder: str = None,
    bf16_compare: bool = True,
    phi_components=None,
    psi_components=None,
    loss_weights: str = "ones",
    n_bins: int = 61,
    final_eval_samples: int = None,
    timesteps: int = 1000,
    eval_interval: int = None,
    resume: bool = False,
    langevin_dt_scale: float = 1.0,
    log_langevin: bool = False,
    device="cuda",
    evaluators: bool = True,
) -> dict:
    """The dipeptide-analogue control (5 beads, phi/psi from von Mises
    mixtures); returns the metric dict.

    ``bf16_compare`` runs a second Langevin stage with the force of the
    bfloat16 network (``langevin_bf16...``, in segments as the float32 one)
    and scores it against the reference and against the float32 stage
    (``js_langevin_bf16``, ``js_bf16_vs_f32``, ``pwd_js_bf16_vs_f32``).
    ``eval_interval`` / ``resume`` give the crash resilience of
    :func:`run_chain_control`. ``evaluators`` builds the trainer's
    per-molecule evaluators, whose scores go to ``results-*.json`` and not
    into the result, and which draw the Ramachandran map (matplotlib);
    ``False`` leaves them out.
    """
    device = resolve_device(device)
    mix = dict(
        phi_components=phi_components or synthetic.PHI_COMPONENTS,
        psi_components=psi_components or synthetic.PSI_COMPONENTS,
    )
    data = synthetic.bimodal_dipeptide_dataset(n_data, seed=seed, **mix)
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "ala2_cg.pdb")).topology
    n_train = int(0.7 * n_data)
    n_val = int(0.1 * n_data)
    trainset, valset, testset = (
        CGDataset(part, topology, "alanine_fold1", mean0=True)
        for part in (data[:n_train], data[n_train:n_train + n_val], data[n_train + n_val:])
    )

    if results_folder is None:
        results_folder = tempfile.mkdtemp(prefix="positive_control_")

    model = GraphTransformer(
        num_beads=5, hidden_nf=hidden_nf, n_layers=n_layers,
        use_intrinsic_coords=True, use_abs_coords=False,
        use_distances=False, conservative=True,
    )
    gd = GaussianDiffusion(model=model, num_atoms=5, timesteps=timesteps,
                           norm_factor=float(trainset.data.std()), loss_weights=loss_weights)
    cfg = TrainConfig(
        mol="alanine_dipeptide_fuberlin",
        data_folder=None,
        results_folder=results_folder,
        tensorboard_folder=os.path.join(results_folder, "runs"),
        experiment_name="positive_control",
        hidden_features_gnn=hidden_nf,
        num_layers_gnn=n_layers,
        diffusion_steps=timesteps,
        loss_weights=loss_weights,
        conservative=True,
        use_intrinsic_coords=True,
        use_abs_coords=False,
        use_distances=False,
        batch_size=batch_size,
        learning_rate=learning_rate,
        min_lr_cosine_anneal=learning_rate / 20,
        train_iter=train_iter,
        eval_interval=eval_interval or train_iter,
        start_from_last_saved=resume,
        iterations_on_val=1,
        log_tensorboard_interval=100,
        num_samples=final_eval_samples or min(2048, num_samples),
        num_samples_final_eval=final_eval_samples or min(2048, num_samples),
        eval_langevin=False,
        seed=seed,
    )
    trainer = Trainer(gd, (trainset, valset, testset), "alanine", cfg, use_tensorboard=False,
                      evaluators=evaluators, device=device)
    trainer.train()
    trainer.save("final")

    # i.i.d. samples through the full reverse chain (EMA weights).
    iid = _cached_stage(results_folder, "iid", lambda: trainer.sample(num_samples), resume)
    finite = np.isfinite(iid).all(axis=(1, 2))
    nonfinite_frac = float(1.0 - finite.mean())
    iid = iid[finite]
    assert len(iid) > 0, "every i.i.d. sample was non-finite"
    reference = synthetic.bimodal_dipeptide_dataset(num_samples, seed=seed + 1, **mix)
    floor_draw = synthetic.bimodal_dipeptide_dataset(num_samples, seed=seed + 2, **mix)
    results = {
        "js_floor": dihedral_js(reference, floor_draw, n_bins=n_bins),
        "js_iid": dihedral_js(iid, reference, n_bins=n_bins),
        "pwd_js_iid": pwd_js(iid, reference),
        "pwd_js_floor": pwd_js(reference, floor_draw),
        # Fraction of reverse chains that blew up; ~0 for a healthy model.
        "nonfinite_frac_iid": nonfinite_frac,
    }

    # Langevin from the extracted force field, the chains started from the
    # model's own i.i.d. samples, so that the metric reflects the model.
    rng = np.random.default_rng(seed + 3)
    init = np.asarray(iid)[rng.integers(0, len(iid), langevin_chains)]
    ema_params = trainer.ema_params()

    def make_sim(bf16):
        return LangevinDiffusion(
            gd, ema_params, init,
            n_timesteps=langevin_steps,
            save_interval=langevin_save_interval,
            t=t_noise, temp_data=300, temp_sim=300,
            dt=None, masses=[12.8] * 5, friction=1.0,
            kb="consistent", random_seed=seed, log=log_langevin,
            bf16=bf16, dt_scale=langevin_dt_scale, device=device,
        )

    stage_suffix = f"_t{t_noise}_dt{langevin_dt_scale:g}_s{langevin_steps}"
    traj_f32 = _segmented_langevin_stage(make_sim(False), results_folder,
                                         f"langevin_f32{stage_suffix}", resume)
    finite_l = np.isfinite(traj_f32).all(axis=(1, 2))
    results["nonfinite_frac_langevin"] = float(1.0 - finite_l.mean())
    if finite_l.all():
        # The basin-exchange report over phi/psi (see run_chain_control).
        erg = slow_torsion_ergodicity(
            traj_f32.reshape(langevin_chains, -1, 5, 3),
            [mix["phi_components"], mix["psi_components"]],
        )
        results["langevin_min_hop_fraction"] = erg["min_hop_fraction"]
        results["langevin_max_occupancy_error"] = erg["max_occupancy_error"]
        results["langevin_ergodic"] = erg["ergodic"]
    traj_f32 = traj_f32[finite_l]
    results["js_langevin_f32"] = dihedral_js(traj_f32, reference, n_bins=n_bins)
    results["pwd_js_langevin_f32"] = pwd_js(traj_f32, reference)
    if bf16_compare:
        traj_bf16 = _segmented_langevin_stage(make_sim(True), results_folder,
                                              f"langevin_bf16{stage_suffix}", resume)
        traj_bf16 = traj_bf16[np.isfinite(traj_bf16).all(axis=(1, 2))]
        results["js_langevin_bf16"] = dihedral_js(traj_bf16, reference, n_bins=n_bins)
        results["js_bf16_vs_f32"] = dihedral_js(traj_bf16, traj_f32, n_bins=n_bins)
        results["pwd_js_bf16_vs_f32"] = pwd_js(traj_bf16, traj_f32)
    results["t_noise_langevin"] = t_noise
    results["langevin_dt_scale"] = langevin_dt_scale
    results["langevin_steps"] = langevin_steps
    results["langevin_chains"] = langevin_chains
    results["results_folder"] = results_folder
    return results
