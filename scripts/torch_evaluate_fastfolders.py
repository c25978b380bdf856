"""Fast-folder evaluation through the PyTorch port: score sampled
conformations (i.i.d. or Langevin trajectories) with PWD JS, TICA JS (and
its map), the RMSD free energy, contact maps and BCE, and, for
trajectories, TIC-space cluster transition matrices. The port's
counterpart of ``scripts/evaluate_fastfolders.py``, with its arguments,
output file and keys.

Usage:
    python scripts/torch_evaluate_fastfolders.py --mol chignolin \
        --samples path/to/sample.npy [--trajectory --n-sims 100] [--out eval_out] \
        [--no_plots]

Differences from the JAX script:

- no ``--device``: the port's evaluators are numpy on the host, so the
  script launches nothing on a GPU;
- ``--no_plots`` leaves out the TICA map, the RMSD free-energy plot and the
  contact map. Without it the plots need matplotlib, and where it is not
  installed the script stops with an error that names the flag;
- ``--trajectory`` clusters with scikit-learn's MiniBatchKMeans
  (``twoforone_torch.evaluate.kinetics.kmeans_centers``), which has to be
  installed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _torch_workflow_common import load_samples, require_plots  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mol", required=True,
                   help="chignolin | trp_cage | bba | villin | protein_g")
    p.add_argument("--samples", required=True)
    p.add_argument("--evalset", default="testset", choices=["testset", "valset"])
    p.add_argument("--out", default="eval_fastfolders_out")
    p.add_argument("--trajectory", action="store_true",
                   help="treat samples as Langevin output for kinetic analysis")
    p.add_argument("--n-sims", type=int, default=100,
                   help="number of parallel chains in the trajectory file")
    p.add_argument("--lagtime", type=int, default=1,
                   help="transition-count lagtime in saved frames")
    p.add_argument("--n-clusters", type=int, default=4)
    p.add_argument("--no_plots", action="store_true",
                   help="score without drawing the plots (no matplotlib needed)")
    args = p.parse_args(argv)
    require_plots(args.no_plots)
    plots = not args.no_plots

    from twoforone_torch.evaluate.evaluators import (
        ContactEvaluator,
        PwdEvaluator,
        RmsdEvaluator,
        TicEvaluator,
    )
    from twoforone_torch.evaluate.kinetics import tic_state_analysis

    samples = load_samples(args.samples)
    os.makedirs(args.out, exist_ok=True)
    results = {}

    mol = args.mol.lower()
    has_tic_golden = mol in ("chignolin", "trp_cage")

    # PWD JS against the golden histograms (offset 3, as the notebook)
    pwd = PwdEvaluator(mol_name=mol, offset=3, evalset=args.evalset)
    results["PWD JS (offset 3)"] = float(pwd.eval(samples))

    # TICA JS and map (golden models exist for chignolin and trp_cage)
    tic = None
    if has_tic_golden:
        tic = TicEvaluator(mol_name=mol, eval_folder=args.out, evalset=args.evalset)
        js, _ = tic.eval(samples, title="script", plot_tic=plots)
        results["TIC JS"] = float(js)

    # RMSD free energy against the golden reference curve
    rmsd = RmsdEvaluator(mol, eval_folder=args.out)
    if os.path.exists(rmsd.saved_ref):
        rmsd.eval("Reference", cutoff=rmsd.cutoff_ref, nbins=100)
    rmsd.eval("Sampled", samples, nbins=100, cutoff=rmsd.cutoff_ref)
    if plots:
        rmsd.plot(save=True)
    results["RMSD mean (A)"] = float(
        np.nanmean(
            np.asarray(
                rmsd.eval("SampledDyn", samples[:10000], nbins=100,
                          cutoff=rmsd.cutoff_ref, save_dynamics=True)["rmsd"]
            )
        )
    )

    # Contacts
    contact = ContactEvaluator(mol, eval_folder=args.out)
    results["Contact BCE to folded"] = float(contact.eval_bce(samples[:10000]))
    if plots:
        contact.plot_contact_normcount(samples[:10000], "Sampled", save=True)

    # Kinetics (trajectories only): TIC clustering and transition matrices
    if args.trajectory and tic is not None:
        n_frames = len(samples) // args.n_sims
        traj = samples[: n_frames * args.n_sims].reshape(
            args.n_sims, n_frames, *samples.shape[1:]
        )
        analysis = tic_state_analysis(
            tic.tica, tic.get_tic_features, traj,
            n_clusters=args.n_clusters, lagtime=args.lagtime,
        )
        results["transition_matrix"] = analysis["transition_matrix"].tolist()
        results["state_counts"] = np.bincount(
            analysis["labels"].ravel(), minlength=args.n_clusters
        ).tolist()

    with open(os.path.join(args.out, f"results_{mol}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items() if not isinstance(v, list)},
                     indent=2))
    return results


if __name__ == "__main__":
    main()
