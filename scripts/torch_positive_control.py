"""Run the positive-control experiment (train -> sample -> evaluate on the
synthetic 4-basin dipeptide analogue) at full budget through the PyTorch
port; prints the metric dict. The port's counterpart of
``scripts/positive_control.py``, with its positional arguments and recipe.

    python scripts/torch_positive_control.py [train_iter] [num_samples] \
        [--device cuda] [--no_plots]

Differences from the JAX script:

- ``--device`` (default ``cuda``; without CUDA the script raises unless
  given ``--device cpu``);
- ``--no_plots`` builds the control without the trainer's evaluators, which
  draw with matplotlib (``run_positive_control(evaluators=False)``); without
  it and without matplotlib the script stops with an error that names the
  flag.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_workflow_common import require_plots  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    # Defaults: the measured recipe of the staged dipeptide control.
    p.add_argument("train_iter", type=int, nargs="?", default=80000)
    p.add_argument("num_samples", type=int, nargs="?", default=40000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_plots", action="store_true",
                   help="leave out the trainer's plotting evaluators")
    args = p.parse_args(argv)

    from twoforone_torch.train.positive_control import run_positive_control
    from twoforone_torch.utils.device import resolve_device

    resolve_device(args.device)
    require_plots(args.no_plots)
    results = run_positive_control(
        train_iter=args.train_iter,
        n_data=200000,
        batch_size=1024,
        hidden_nf=64,
        n_layers=3,
        learning_rate=6e-4,
        num_samples=args.num_samples,
        langevin_chains=256,
        langevin_steps=30000,
        langevin_save_interval=100,
        device=args.device,
        evaluators=not args.no_plots,
    )
    print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main()
