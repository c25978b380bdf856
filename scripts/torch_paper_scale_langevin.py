"""Paper-scale Langevin production run on the trained chignolin-scale
control, through the PyTorch port: the reference's headline sampling
command at full size,

    100 chains x 6,000,000 steps, save_interval 500  (1.2M saved frames)

in the segment-streamed, resumable form of
``scripts/paper_scale_langevin.py``, whose arguments, files and
``results.json`` keys it keeps:

- the run advances in segments of ``--segment_steps``; each segment's frames
  are written atomically to ``<out>/coords_seg{NNN}.npy`` (data units)
  before the integrator state goes to ``<out>/state.npz``, and ``meta.json``
  after both;
- the segment cursor is the integrator's step count ``t``, never
  ``meta.json``, so a crash between the two writes redoes the segment and
  overwrites its file with the same frames;
- the run yields at every segment boundary when ``TWOFORONE_PREEMPT_FLAG``
  names a file that exists (exit code 75, ``utils/preempt.py``);
- a relaunch with the same ``--out`` resumes from ``state.npz`` and skips
  the i.i.d. initialisation; the frames equal those of a run that was never
  stopped, bit for bit (the per-step noise comes from one generator whose
  state is checkpointed with the coordinates).

With ``fused="auto"`` on the card, chain10 runs the fused force kernel.
Results land in ``<out>/results.json``.

    python scripts/torch_paper_scale_langevin.py [--out DIR] [--device cuda]

Differences from the JAX script:

- the initial condition is drawn from a ``torch.Generator`` seeded 7 on the
  run's device (the JAX script uses ``jax.random.PRNGKey(7)``), so the
  trajectory differs from the JAX package's; it is the same in every
  process of the port on the same device;
- the i.i.d. initialisation goes through
  ``make_fused_sample_fn(kernel="auto")``: on the card the 1000-step
  ancestral chain runs the fused force kernel, on the host the plain
  network, as the JAX script's ``gd.sample``;
- ``--artifact_dir`` reads the control from another folder than the JAX
  package's staged ``assets/trained/chain10``;
- ``--device`` (default ``cuda``; without CUDA the script raises unless
  given ``--device cpu``);
- the norm factor is cached in ``<out>/norm_factor.json`` (the JAX script
  caches it in ``.controls/chain10_norm_factor.json``; neither package
  reads the other's);
- segment times are read after ``torch.cuda.synchronize()``, and every
  printed rate names the card and its power limit.
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _torch_workflow_common import (  # noqa: E402
    REPO,
    atomic_json,
    card_label,
    dataset_norm_factor,
    rebuild_control,
    synchronize,
)

N_BEADS = 10
INIT_SEED = 7


def build_chain10(out, artifact_dir=None):
    """The chain10 control's diffusion and weights, rebuilt as
    ``run_chain_control(n_beads=10, seed=0)`` built them: the norm factor is
    the train split's std of the seed-0 synthetic dataset, recomputed once a
    run folder (``<out>/norm_factor.json``, written only by this
    computation) rather than trusted to a side channel."""
    cache = os.path.join(out, "norm_factor.json")
    if os.path.exists(cache):
        with open(cache) as f:
            norm_factor = float(json.load(f)["norm_factor"])
    else:
        norm_factor = dataset_norm_factor(N_BEADS)
        atomic_json(cache, {"norm_factor": norm_factor,
                            "provenance": "build_chain10 (400k seed-0)"})
    gd, params, _ = rebuild_control(N_BEADS, norm_factor, artifact_dir)
    return gd, params


def segment_frames(out, n_segments):
    """The frames of a run's first ``n_segments`` segment files, in order:
    (chains, saves, beads, 3)."""
    return np.concatenate([np.load(os.path.join(out, f"coords_seg{s:03d}.npy"))
                           for s in range(n_segments)], axis=1)


@functools.lru_cache(maxsize=None)
def tic_scorer():
    """The chain10 TIC scorer of the control runs (built once a process)."""
    from twoforone_torch.data.synthetic import (
        CHAIN10_TORSION_COMPONENTS,
        chain_dataset,
        chain_trajectory,
    )
    from twoforone_torch.train.positive_control import SyntheticTicScorer

    return SyntheticTicScorer(
        chain_trajectory(200000, CHAIN10_TORSION_COMPONENTS, seed=10),
        chain_dataset(50000, CHAIN10_TORSION_COMPONENTS, seed=11),
    )


def score_frames(frames):
    """The control runs' scores of a run's frames (chains, saves, beads, 3)."""
    from twoforone_torch.data.synthetic import CHAIN10_TORSION_COMPONENTS
    from twoforone_torch.evaluate.ergodicity import slow_torsion_ergodicity

    finite = np.isfinite(frames).all(axis=(1, 2, 3))
    erg = slow_torsion_ergodicity(frames, CHAIN10_TORSION_COMPONENTS)
    return {
        "frames_saved": int(frames.shape[0] * frames.shape[1]),
        "nonfinite_chain_frac": float(1.0 - finite.mean()),
        "tic_js_langevin": tic_scorer().tic_js(
            frames[finite].reshape(-1, N_BEADS, 3)),
        "langevin_min_hop_fraction": erg["min_hop_fraction"],
        "langevin_max_occupancy_error": erg["max_occupancy_error"],
        "langevin_ergodic": erg["ergodic"],
        # Over a production-length window the median chain should cross
        # every slow torsion.
        "min_median_hops_per_chain": min(
            (s["median_hops_per_chain"] for s in erg["per_torsion"].values()),
            default=None,
        ),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, ".controls", "torch_paper_scale_run"))
    p.add_argument("--chains", type=int, default=100)
    p.add_argument("--steps", type=int, default=6_000_000)
    p.add_argument("--save_interval", type=int, default=500)
    # One segment = one checkpoint / stream / preemption boundary: a kill
    # costs at most one segment's steps.
    p.add_argument("--segment_steps", type=int, default=200_000)
    p.add_argument("--t_noise", type=int, default=20)     # chain10 preset
    p.add_argument("--temp", type=float, default=340.0)   # chignolin (K)
    p.add_argument("--artifact_dir", default=None,
                   help="staged control folder (default: twoforone_tpu/assets/trained/chain10)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.segment_steps % args.save_interval or args.steps % args.segment_steps:
        p.error("--segment_steps must be a multiple of --save_interval, and --steps of "
                "--segment_steps")

    import torch

    from twoforone_torch.data.molecules import default_dt_scale
    from twoforone_torch.dynamics.langevin import LangevinDiffusion
    from twoforone_torch.dynamics.segmented import _atomic_save, _atomic_savez
    from twoforone_torch.utils.device import resolve_device
    from twoforone_torch.utils.preempt import exit_if_preempted

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    state_path = os.path.join(args.out, "state.npz")
    meta_path = os.path.join(args.out, "meta.json")

    gd, params = build_chain10(args.out, args.artifact_dir)

    # Chains start from the model's own i.i.d. samples (the reference's
    # langevin gen_mode). On resume the state checkpoint supersedes the
    # initial condition (load_state below), so the reverse chain is skipped;
    # the persisted x is in normalized units and LangevinDiffusion divides
    # its init by norm_factor, hence the scaling back.
    if os.path.exists(state_path):
        init = np.asarray(np.load(state_path)["x"],
                          dtype=np.float32) * float(gd.norm_factor)
    else:
        sample = gd.make_fused_sample_fn(params, args.chains, kernel="auto", device=device)
        generator = torch.Generator(device=device).manual_seed(INIT_SEED)
        init = sample(generator).cpu().numpy()

    dt_scale = default_dt_scale("CHIGNOLIN", N_BEADS)
    sim = LangevinDiffusion(
        gd, params, init,
        n_timesteps=args.steps, save_interval=args.save_interval,
        t=args.t_noise, temp_data=args.temp, temp_sim=args.temp,
        dt=None, masses=[12.0] * N_BEADS, friction=1.0, kb="consistent",
        random_seed=0, log=True, fused="auto", dt_scale=dt_scale, device=device,
    )

    meta = {"chains": args.chains, "steps": args.steps,
            "save_interval": args.save_interval,
            "segment_steps": args.segment_steps,
            "t_noise": args.t_noise, "temp": args.temp,
            "dt_scale": dt_scale, "integration_wall_s": 0.0,
            "resumes": 0, "segments_done": 0}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
        meta["resumes"] += 1
    if os.path.exists(state_path):
        st = np.load(state_path)
        sim.sim.load_state({
            "x": st["x"], "v": None if st["v"].ndim == 0 else st["v"],
            "t": int(st["t"]), "key": st["key"],
        })
        print(f"resumed at step {sim.sim._t} (resume #{meta['resumes']})")

    card = card_label(device)
    n_segments = args.steps // args.segment_steps
    # The segment cursor is the integrator state itself, never the meta
    # file: a crash between the state checkpoint and the meta update must
    # re-derive the next segment from t, or the wrong segment file would be
    # overwritten with the following segment's frames.
    while (seg := sim.sim._t // args.segment_steps) < n_segments:
        exit_if_preempted(f"paper-scale segment {seg}/{n_segments}")
        synchronize(device)
        t0 = time.perf_counter()
        coords = sim.sim.simulate(sub_interval=args.segment_steps)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        # This segment's frames (data units) go to disk before the state
        # checkpoint: a crash between the two re-runs the segment, which
        # overwrites the same file with the same frames, never duplicates
        # them.
        _atomic_save(os.path.join(args.out, f"coords_seg{seg:03d}.npy"),
                     (coords * sim.norm_factor).astype(np.float32))
        st = sim.sim.state
        _atomic_savez(
            state_path, x=st["x"],
            v=np.zeros(()) if st["v"] is None else st["v"],
            t=st["t"], key=st["key"],
        )
        meta["segments_done"] = seg + 1  # informational; the cursor is the state's t
        meta["integration_wall_s"] += elapsed
        atomic_json(meta_path, meta)
        sps = args.segment_steps / elapsed
        print(f"segment {seg + 1}/{n_segments}: {elapsed:.1f}s "
              f"({sps:.0f} steps/s, {sps * args.chains:.0f} chain-steps/s on {card}), "
              f"total {meta['integration_wall_s']:.0f}s", flush=True)

    # ---- scoring (the control runs' contract, on the whole run's frames)
    frames = segment_frames(args.out, n_segments)
    assert frames.shape == (args.chains, args.steps // args.save_interval,
                            N_BEADS, 3), frames.shape
    total_steps = args.steps
    results = {
        "workload": f"{args.chains}x{args.steps} si{args.save_interval}",
        **score_frames(frames),
        "integration_wall_s": round(meta["integration_wall_s"], 1),
        "steps_per_s": round(total_steps / meta["integration_wall_s"], 1),
        "chain_steps_per_s": round(
            total_steps * args.chains / meta["integration_wall_s"], 1),
        "resumes": meta["resumes"],
        "dt_scale": dt_scale, "t_noise": args.t_noise,
    }
    atomic_json(os.path.join(args.out, "results.json"), results)
    print(f"rates measured on: {card}")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
