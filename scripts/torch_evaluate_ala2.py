"""Alanine-dipeptide evaluation through the PyTorch port: score a sample
file against the golden dihedral references (Ramachandran free energy and
dihedral JS / KL / MSE per fold). The port's counterpart of
``scripts/evaluate_ala2.py``, with its arguments, output file and keys.

Usage:
    python scripts/torch_evaluate_ala2.py --samples path/to/sample-iid.npy \
        [--fold 1] [--evalset testset] [--out eval_ala2_out] [--no_plots]

Differences from the JAX script:

- no ``--device``: the port's evaluators are numpy on the host, so the
  script launches nothing on a GPU;
- ``--no_plots`` leaves out the Ramachandran plots. Without it the plots
  need matplotlib, and where it is not installed the script stops with an
  error that names the flag.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_workflow_common import load_samples, require_plots  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples", required=True, help=".npy/.npz/.pt file of (B, 5, 3) Angstrom coords")
    p.add_argument("--fold", type=int, default=None, help="use fold-specific golden reference")
    p.add_argument("--evalset", default="testset", choices=["testset", "valset"])
    p.add_argument("--out", default="eval_ala2_out")
    p.add_argument("--no_plots", action="store_true",
                   help="score without drawing the Ramachandran plots (no matplotlib needed)")
    args = p.parse_args(argv)
    require_plots(args.no_plots)

    from twoforone_torch.data.molecules import SAVED_REFERENCES_DIR
    from twoforone_torch.evaluate.evaluators import DihedralEnergiesEvaluator

    samples = load_samples(args.samples)
    if samples.ndim != 3 or samples.shape[1:] != (5, 3):
        p.error(f"expected samples of shape (B, 5, 3), got {samples.shape}")

    if args.fold is not None:
        ref = os.path.join(
            SAVED_REFERENCES_DIR,
            f"saved_dih_probs_ala2_fold_{args.fold}_{args.evalset}.pickle",
        )
    else:
        ref = os.path.join(SAVED_REFERENCES_DIR, "saved_dih_probs_ala2_testset.pickle")

    os.makedirs(args.out, exist_ok=True)
    ev = DihedralEnergiesEvaluator(plots_folder=args.out, saved_ref=ref)
    mse, js, kl1, kl2 = ev.eval(samples, plot_freeE=not args.no_plots, milestone="script")
    results = {
        "Dihedral free-energy MSE (kcal/mol)^2": float(mse),
        "Dihedral JS": float(js),
        "KL(sample||ref)": float(kl1),
        "KL(ref||sample)": float(kl2),
    }
    with open(os.path.join(args.out, "results_ala2.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
