"""Strided-solver quality against steps on a staged trained chain{N}
control, through the PyTorch port: strided DDIM / DPM-Solver++(2M) i.i.d.
samples scored against the ``SyntheticTicScorer`` the control uses, beside
the full ancestral chain and the statistical floor, i.e. how much TIC JS
the T/steps speed-up costs. The port's counterpart of
``scripts/ddim_quality.py``, with its arguments, defaults and JSON keys. It
samples through ``gd.make_sample_fn``, the plain network, as the JAX
script does: no fused kernel runs here.

    python scripts/torch_ddim_quality.py [--n_beads 10|20|28|35|56]
        [--steps 200 100 50 20] [--num_samples 100000]
        [--ancestral] [--artifact_dir DIR] [--device cuda|cpu]

Differences from the JAX script:

- ``--device`` is a torch device (default ``cuda``; without CUDA the script
  raises unless given ``--device cpu``), where the JAX script's
  ``cpu | default`` chose JAX's platform;
- ``--artifact_dir`` reads the control from another folder than the JAX
  package's staged ``assets/trained/chain{N}`` (the JAX script's
  ``rebuild_control`` takes it, its command line does not);
- the batches are drawn one after another from one ``torch.Generator``
  seeded 100 on the device (the JAX script splits ``PRNGKey(100)``), so the
  samples differ from the JAX package's;
- samples/s is read after ``torch.cuda.synchronize()`` and printed beside
  the card's name and power limit.
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
    p.add_argument("--n_beads", type=int, default=10)
    p.add_argument("--steps", type=int, nargs="+", default=[200, 100, 50, 20])
    p.add_argument("--solver", default="ddim", choices=["ddim", "dpm2m"])
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--num_samples", type=int, default=100000)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--ancestral", action="store_true",
                   help="also score the full T=1000 ancestral chain")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 score-net compute in the reverse chain "
                        "(core/diffusion.py sample(bf16=True))")
    p.add_argument("--artifact_dir", default=None)
    p.add_argument("--out", default=None, help="write results JSON here")
    args = p.parse_args(argv)

    import torch

    from twoforone_torch.data.synthetic import chain_dataset, chain_trajectory
    from twoforone_torch.train.positive_control import SyntheticTicScorer
    from twoforone_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    gd, params, comp = rebuild_control(args.n_beads, split_norm_factor(args.n_beads),
                                       args.artifact_dir)

    scorer = SyntheticTicScorer(
        chain_trajectory(200000, comp, seed=10),
        chain_dataset(args.num_samples, comp, seed=11),
    )
    floor = scorer.tic_js(chain_dataset(args.num_samples, comp, seed=12))
    results = {"n_beads": args.n_beads, "tic_js_floor": floor,
               "eta": args.eta, "solver": args.solver, "bf16": args.bf16,
               "num_samples": args.num_samples}
    card = card_label(device)
    print(f"n_beads={args.n_beads} floor: {floor:.4f}  solver: {args.solver}"
          f"{'  bf16' if args.bf16 else ''}")

    def draw(sample_steps):
        fn = gd.make_sample_fn(params, args.batch, sample_steps=sample_steps,
                               eta=args.eta, solver=args.solver, bf16=args.bf16,
                               device=device)
        outs, generator = [], torch.Generator(device=device).manual_seed(100)
        synchronize(device)
        t0 = time.perf_counter()
        n_batches = (args.num_samples + args.batch - 1) // args.batch
        for i in range(n_batches):
            outs.append(fn(generator).cpu().numpy())
            # A heartbeat: a long draw is otherwise silent, and a launcher
            # watching the log tells a slow solver from a wedged run by it.
            print(f"  batch {i + 1}/{n_batches} ({time.strftime('%H:%M:%S')})",
                  flush=True)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        samples = np.concatenate(outs)[: args.num_samples]
        finite = np.isfinite(samples).all(axis=(1, 2))
        return samples[finite], elapsed, float(1 - finite.mean())

    ladders = list(args.steps) + ([1000] if args.ancestral else [])
    for k in ladders:
        samples, elapsed, nonfinite = draw(None if k == 1000 else k)
        js = scorer.tic_js(samples)
        results[f"tic_js_steps_{k}"] = js
        results[f"samples_per_sec_steps_{k}"] = round(len(samples) / elapsed, 2)
        print(f"steps={k}: TIC-JS {js:.4f}  "
              f"({len(samples) / elapsed:.1f} samples/s on {card}, "
              f"nonfinite {nonfinite:.4f})", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
