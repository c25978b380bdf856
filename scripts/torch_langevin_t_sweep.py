"""Noise-level (t) sweep for the force field of a trained control, through
the PyTorch port: short Langevin runs at each candidate t, scored with the
``SyntheticTicScorer`` the control uses, chains initialized from the
control's own i.i.d. samples (the reference's ``--gen_mode langevin``
procedure). The port's counterpart of ``scripts/langevin_t_sweep.py``,
with its arguments, defaults and JSON keys. With ``fused="auto"`` on the
card, a chain of at most 10 beads runs the fused force kernel, 11-32 beads
the attention-core kernel pair (clx), more the plain network.

    python scripts/torch_langevin_t_sweep.py --n_beads 35 \
        --artifact_dir .controls/torch_trained/chain35 \
        --init .controls/chain35_run/post_iid.npy \
        --t 3 5 8 10 15 20 30

Differences from the JAX script:

- ``--device`` (default ``cuda``; without CUDA the script raises unless
  given ``--device cpu``);
- the control is rebuilt by ``_torch_workflow_common.rebuild_control``
  (the JAX script's ``ddim_quality.rebuild_control``, the same norm factor
  ``traj[:280000].std()``); the Langevin noise comes from the port's
  generator seeded ``--seed``, so trajectories differ from the JAX
  package's;
- each t's simulation time is read after ``torch.cuda.synchronize()`` and
  printed with its steps/s beside the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _torch_workflow_common import (  # noqa: E402
    card_label,
    rebuild_control,
    split_norm_factor,
    synchronize,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_beads", type=int, default=35)
    p.add_argument("--artifact_dir", default=None)
    p.add_argument("--init", required=True,
                   help=".npy of iid samples to draw initial chains from")
    p.add_argument("--t", type=int, nargs="+",
                   default=[3, 5, 8, 10, 15, 20, 30])
    p.add_argument("--chains", type=int, default=500)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--save_interval", type=int, default=250)
    p.add_argument("--eval_samples", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dt_scale", type=float, default=1.0)
    p.add_argument("--save_traj", default=None,
                   help="save the raw trajectory of the LAST t here (.npy); "
                   "with control-matching chains/steps/seed it is reusable "
                   "as the control's cached post_langevin.npy stage")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from twoforone_torch.data.synthetic import chain_dataset, chain_trajectory
    from twoforone_torch.dynamics.langevin import LangevinDiffusion
    from twoforone_torch.train.positive_control import (
        CHAIN_CONTROL_PRESETS,
        SyntheticTicScorer,
    )
    from twoforone_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print("rebuilding control...", flush=True)
    gd, params, comp = rebuild_control(args.n_beads, split_norm_factor(args.n_beads),
                                       args.artifact_dir)
    preset = CHAIN_CONTROL_PRESETS[args.n_beads]

    iid = np.load(args.init)
    iid = iid[np.isfinite(iid).all(axis=(1, 2))]
    rng = np.random.default_rng(args.seed + 3)
    init = iid[rng.integers(0, len(iid), args.chains)]

    # All simulations first (on the card), scoring after (on the host), so
    # that the card is free as early as possible.
    card = card_label(device)
    trajs, rates = {}, {}
    for t in args.t:
        sim = LangevinDiffusion(
            gd, params, init,
            n_timesteps=args.steps, save_interval=args.save_interval,
            t=t, temp_data=preset["temp"], temp_sim=preset["temp"],
            dt=None, masses=[12.0] * args.n_beads, friction=1.0,
            kb="consistent", random_seed=args.seed, log=False, fused="auto",
            dt_scale=args.dt_scale, device=device,
        )
        synchronize(device)
        t0 = time.perf_counter()
        trajs[t] = np.asarray(sim.sample())
        synchronize(device)
        elapsed = time.perf_counter() - t0
        rates[t] = args.steps / elapsed
        if args.save_traj:
            tmp = args.save_traj + ".tmp.npy"
            np.save(tmp, trajs[t])
            os.replace(tmp, args.save_traj)
        print(f"t={t:3d}  simulated  ({elapsed:.1f}s, {rates[t]:.1f} steps/s, "
              f"path {sim.force_fn.mode} on {card})", flush=True)
    print("sims done", flush=True)

    print("fitting scorer...", flush=True)
    scorer = SyntheticTicScorer(
        chain_trajectory(200000, comp, seed=args.seed + 10),
        chain_dataset(args.eval_samples, comp, seed=args.seed + 11),
    )
    floor = scorer.tic_js(
        chain_dataset(args.eval_samples, comp, seed=args.seed + 12)
    )

    results = {"n_beads": args.n_beads, "tic_js_floor": floor,
               "chains": args.chains, "steps": args.steps,
               "dt_scale": args.dt_scale, "t": {}}
    print(f"floor={floor:.4f}  iid_js={scorer.tic_js(iid):.4f}", flush=True)
    for t, traj in trajs.items():
        finite = np.isfinite(traj).all(axis=(1, 2))
        js = scorer.tic_js(traj[finite]) if finite.any() else float("nan")
        results["t"][t] = {
            "tic_js": js,
            "nonfinite_frac": float(1.0 - finite.mean()),
        }
        print(f"t={t:3d}  tic_js={js:.4f}  "
              f"nonfinite={1.0 - finite.mean():.4f}", flush=True)

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results, rates


if __name__ == "__main__":
    main()
