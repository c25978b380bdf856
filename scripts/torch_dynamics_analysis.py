"""Offline dynamics analysis of a control run's saved Langevin trajectory,
through the PyTorch port. The port's counterpart of
``scripts/dynamics_analysis.py``, with its arguments and JSON keys:

1. **Slow-torsion ergodicity** (``evaluate/ergodicity.py``): per bimodal
   torsion, the fraction of chains that crossed basins, the pooled hop rate
   and the basin-occupancy error against the generator's weights;
2. **TIC-space transition-count matrices** (``evaluate/kinetics.py``): the
   reference fast-folder notebook's dynamics analysis on trained-model
   output: MiniBatchKMeans states in the 2D TIC plane, sliding transition
   counts per chain, the row-normalized transition matrix.

Host-only (numpy and the TICA fit; scikit-learn for the clustering), so it
runs beside a run that holds the card.

    python scripts/torch_dynamics_analysis.py --n_beads 35 [--chains 1000] \
        [--traj path/to/post_langevin.npy] [--out dynamics_chain35.json]

Differences from the JAX script:

- it writes ``--out`` (default ``.controls/torch_dynamics_chain{N}.json``),
  never ``docs/dynamics_chain{N}.json``;
- no JAX platform to choose: the analysis is numpy on the host.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _torch_workflow_common import REPO  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_beads", type=int, default=35)
    p.add_argument("--chains", type=int, default=1000,
                   help="langevin_chains of the control run (layout recovery)")
    p.add_argument("--traj", type=str, default=None,
                   help="override trajectory path (default: .controls/chain{N}_run/post_langevin.npy)")
    p.add_argument("--n_clusters", type=int, default=4)
    p.add_argument("--lagtime", type=int, default=1,
                   help="transition-count lag in SAVED frames")
    p.add_argument("--ref_frames", type=int, default=200000)
    p.add_argument("--out", default=None,
                   help="results JSON (default: .controls/torch_dynamics_chain{N}.json)")
    args = p.parse_args(argv)

    from twoforone_torch.data.synthetic import chain_dataset, chain_trajectory
    from twoforone_torch.evaluate.ergodicity import slow_torsion_ergodicity
    from twoforone_torch.evaluate.kinetics import tic_state_analysis
    from twoforone_torch.train.positive_control import (
        SyntheticTicScorer,
        _tic_features,
        chain_control_components,
    )

    n = args.n_beads
    components = chain_control_components(n)

    traj_path = args.traj
    if traj_path is None:
        # The newest Langevin stage product: stage caches are keyed by the
        # knobs that define them (post_langevin_t{t}_dt{scale}_s{steps}.npy,
        # plain post_langevin.npy before that).
        import glob

        candidates = sorted(
            glob.glob(os.path.join(REPO, ".controls", f"chain{n}_run",
                                   "post_langevin*.npy")),
            key=os.path.getmtime,
        )
        if not candidates:
            raise SystemExit(f"no post_langevin*.npy under "
                             f".controls/chain{n}_run — pass --traj")
        traj_path = candidates[-1]
    traj = np.load(traj_path)
    traj = traj.reshape(args.chains, -1, n, 3)
    print(f"trajectory {traj_path}: {traj.shape} (chains, frames, beads, 3)")

    erg = slow_torsion_ergodicity(traj, components)
    print(json.dumps({k: v for k, v in erg.items() if k != "per_torsion"}))

    # The notebook's transition analysis: TICA fit on an independent
    # Metropolis reference trajectory (the control's own scorer recipe),
    # k-means states over the pooled Langevin TIC projections.
    scorer = SyntheticTicScorer(
        chain_trajectory(args.ref_frames, components, seed=10),
        chain_dataset(50000, components, seed=11),
    )
    analysis = tic_state_analysis(
        scorer.tica, _tic_features, traj,
        n_clusters=args.n_clusters, lagtime=args.lagtime,
    )
    counts = analysis["counts"]
    off_diag = float(counts.sum() - np.trace(counts)) / max(counts.sum(), 1)

    out = {
        "n_beads": n,
        "trajectory": os.path.relpath(traj_path, REPO),
        "shape": list(traj.shape),
        "ergodicity": {
            **{k: v for k, v in erg.items() if k != "per_torsion"},
            "per_torsion": {
                str(k): v for k, v in erg["per_torsion"].items()
            },
        },
        "tic_transitions": {
            "n_clusters": args.n_clusters,
            "lagtime_saved_frames": args.lagtime,
            "counts": counts.tolist(),
            "transition_matrix": np.round(
                analysis["transition_matrix"], 5
            ).tolist(),
            "off_diagonal_fraction": off_diag,
            "states_visited": int((counts.sum(axis=1) > 0).sum()),
        },
    }
    out_path = args.out or os.path.join(REPO, ".controls", f"torch_dynamics_chain{n}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {out_path}")
    print(f"TIC off-diagonal transition fraction: {off_diag:.4f}; "
          f"states visited: {out['tic_transitions']['states_visited']}/{args.n_clusters}")
    return out


if __name__ == "__main__":
    main()
