"""Production-scale synthetic-protein control runs through the PyTorch
port: train the published model shape for a protein size on the synthetic
multi-basin chain system, score TIC JS / PWD JS with the evaluator
machinery, and stage the trained checkpoint when it clears the physics
bars. The port's counterpart of ``scripts/chain10_control.py``, with its
arguments, ``run_chain_control`` / ``run_positive_control`` kwargs,
``--quick`` budgets and staging gate (``physics_bars_ok``,
``dipeptide_bars_ok``, ``--force_stage``).

    python scripts/torch_chain10_control.py                 # chignolin-scale N=10
    python scripts/torch_chain10_control.py --n_beads 20    # trp_cage-scale N=20 (clx path)
    python scripts/torch_chain10_control.py --n_beads 5     # the dipeptide analogue (ala5)
    python scripts/torch_chain10_control.py --quick         # reduced budget

Differences from the JAX script:

- it stages into ``--stage_dir`` (default ``.controls/torch_trained/<artifact>/``)
  and never into ``twoforone_tpu/assets/trained/``. It stages the same three
  files; the checkpoint holds flax's bytes, so the JAX package reads a
  control staged here, and the port's workflow scripts read it through
  their ``--artifact_dir``;
- ``--device`` (default ``cuda``; without CUDA the script raises unless
  given ``--device cpu``);
- ``--no_plots`` builds the dipeptide control (``--n_beads 5``) without the
  trainer's evaluators, which draw with matplotlib
  (``run_positive_control(evaluators=False)``); without it and without
  matplotlib the script stops with an error that names the flag. The chain
  controls draw nothing.
"""

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_workflow_common import TORCH_STAGED, require_plots  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_beads", type=int, default=10)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--train_iter", type=int, default=None)
    p.add_argument("--fused", type=str, default="auto")
    p.add_argument("--stage_artifact", type=lambda v: v != "false", default=True)
    p.add_argument("--force_stage", action="store_true",
                   help="stage even when the physics bars fail")
    # Crash resilience for long runs: checkpoint every eval_interval steps
    # into a stable folder and resume from the last milestone on relaunch.
    p.add_argument("--results_folder", type=str, default=None)
    p.add_argument("--eval_interval", type=int, default=10000)
    p.add_argument("--resume", action="store_true")
    # Langevin noise-level override: scripts/torch_langevin_t_sweep.py is the
    # tuning loop for a control; its winner re-runs just the (cached)
    # Langevin stage at the tuned t.
    p.add_argument("--t_noise", type=int, default=None)
    p.add_argument("--langevin_dt_scale", type=float, default=None,
                   help="default: the measured per-protein production value "
                        "(data/molecules.default_dt_scale)")
    # Langevin window overrides: the hop-fraction bar depends on the
    # window's length, so a control whose window was too short to see hops
    # is re-run with a longer budget, not a weaker bar. The stage cache is
    # keyed by these knobs (post_langevin_t{t}_dt{scale}_s{steps}.npy).
    p.add_argument("--langevin_steps", type=int, default=None)
    p.add_argument("--langevin_chains", type=int, default=None)
    p.add_argument("--stage_dir", default=None,
                   help="where to stage (default: .controls/torch_trained/<artifact>)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_plots", action="store_true",
                   help="the dipeptide control without the trainer's plotting evaluators")
    args = p.parse_args(argv)

    from twoforone_torch.train.positive_control import (
        ALA5_CONTROL_PRESET,
        dipeptide_bars_ok,
        physics_bars_ok,
        run_chain_control,
        run_positive_control,
    )
    from twoforone_torch.utils.device import resolve_device

    resolve_device(args.device)
    # n_beads=5 is the ala2-analogue (dihedral-JS family) production control:
    # the dipeptide experiment with its measured recipe and dihedral bars.
    ala5 = args.n_beads == 5
    if ala5:
        require_plots(args.no_plots)
        kwargs = dict(ALA5_CONTROL_PRESET,
                      eval_interval=args.eval_interval, resume=args.resume,
                      log_langevin=True, evaluators=not args.no_plots)
    else:
        kwargs = dict(n_beads=args.n_beads, fused=args.fused,
                      eval_interval=args.eval_interval, resume=args.resume)
    kwargs["device"] = args.device
    if args.results_folder:
        os.makedirs(args.results_folder, exist_ok=True)
        kwargs["results_folder"] = args.results_folder
    if args.quick:
        if ala5:
            kwargs.update(train_iter=8000, n_data=60000, num_samples=20000,
                          langevin_chains=128, langevin_steps=10000)
        else:
            kwargs.update(
                train_iter=8000, n_data=120000, num_samples=20000,
                langevin_chains=256, langevin_steps=20000, eval_samples=20000,
            )
    if args.train_iter:
        kwargs["train_iter"] = args.train_iter
    if args.t_noise is not None:
        kwargs["t_noise"] = args.t_noise
    if args.langevin_dt_scale is not None:
        kwargs["langevin_dt_scale"] = args.langevin_dt_scale
    if args.langevin_steps is not None:
        kwargs["langevin_steps"] = args.langevin_steps
    if args.langevin_chains is not None:
        kwargs["langevin_chains"] = args.langevin_chains

    t0 = time.time()
    results = (run_positive_control if ala5 else run_chain_control)(**kwargs)
    results["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(results, indent=2))

    # Staging gate: only results that clear the bars the staged controls
    # are held to are staged, unless --force_stage says otherwise.
    bars_ok = dipeptide_bars_ok if ala5 else physics_bars_ok
    stage = args.stage_artifact
    if stage and not (bars_ok(results) or args.force_stage):
        print("physics bars FAILED — not staging (use --force_stage to override)")
        stage = False
    if stage:
        artifact = "ala5" if ala5 else f"chain{args.n_beads}"
        artifact_dir = args.stage_dir or os.path.join(TORCH_STAGED, artifact)
        os.makedirs(artifact_dir, exist_ok=True)
        src = os.path.join(
            results["results_folder"],
            "positive_control_" if ala5 else f"chain{args.n_beads}_control_",
        )
        for name in ("model-best.msgpack", "config.json"):
            path = os.path.join(src, name)
            if os.path.exists(path):
                shutil.copy(path, os.path.join(artifact_dir, name))
        with open(os.path.join(artifact_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(f"artifact staged at {artifact_dir}")
    return results


if __name__ == "__main__":
    main()
