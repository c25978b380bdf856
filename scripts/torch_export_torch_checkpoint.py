"""Export a checkpoint to the reference's torch format through the PyTorch
port. The port's counterpart of ``scripts/export_torch_checkpoint.py``,
with its arguments and files.

Writes a ``model-<name>.pt`` whose "ema" entry holds the full ema-pytorch
``EMA(GaussianDiffusion)`` state dict under the reference's key layout
(``ema_model.model.<...>``, built by
``twoforone_torch.utils.convert.build_ema_pytorch_state_dict``), so samples
can be drawn with the upstream ``sample.py`` for cross-validation, and an
``args.pickle``-style namespace built from config.json.

Usage:
    python scripts/torch_export_torch_checkpoint.py --model_path results/run \
        [--checkpoint best] [--out results/run/export]

Differences from the JAX script: none in its arguments or files. The
checkpoint is read by the port's loader (a flax ``.msgpack`` or a
reference ``.pt``) on the host; nothing runs on a GPU.
"""

import argparse
import os
import pickle
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from twoforone_torch.cli.sample import load_model
    from twoforone_torch.utils.convert import build_ema_pytorch_state_dict

    gd, ema_params, trainset, cfg = load_model(args.model_path, args.checkpoint,
                                               device="cpu")
    # The full ema-pytorch 0.0.8 EMA(GaussianDiffusion) state dict: the
    # upstream sample.py load is strict, so every key (online_model.*,
    # ema_model.*, DDPM buffers, initted, step) must be present.
    ema_state = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in build_ema_pytorch_state_dict(gd, ema_params).items()
    }

    out = args.out or os.path.join(args.model_path, "export")
    os.makedirs(out, exist_ok=True)
    torch.save({"ema": ema_state}, os.path.join(out, f"model-{args.checkpoint}.pt"))

    ns = SimpleNamespace(**{k: v for k, v in cfg.__dict__.items() if k != "extra"})
    with open(os.path.join(out, "args.pickle"), "wb") as f:
        pickle.dump(ns, f)
    print(f"exported torch checkpoint + args.pickle to {out}")
    return out


if __name__ == "__main__":
    main()
