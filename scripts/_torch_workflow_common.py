"""Shared pieces of the port's workflow scripts (``scripts/torch_*.py``).

A staged chain control is rebuilt from files read by path: the preset's
model shape (``CHAIN_CONTROL_PRESETS``), a norm factor recomputed from the
seed-0 synthetic trajectory, and the EMA weights of the staged checkpoint.
Each script keeps its JAX counterpart's norm-factor formula:

- ``paper_scale_langevin.py`` takes the std of the mean-centred train split,
  ``CGDataset(traj[:280000], ..., mean0=True).data.std()``
  (:func:`dataset_norm_factor`);
- ``ddim_quality.py`` and ``langevin_t_sweep.py`` take ``traj[:280000].std()``
  (:func:`split_norm_factor`).

The control is read from ``artifact_dir``, by default the JAX package's
staged folder ``twoforone_tpu/assets/trained/chain{N}/``; a control that
``torch_chain10_control.py`` staged elsewhere is read from there. Nothing
here imports JAX or the JAX package. Each norm factor is computed once a
process (its 400 000-frame trajectory takes seconds on a host core), so that
a process that runs several scripts' ``main`` pays for it once.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: The JAX package's staged controls, read by path.
ASSETS_TRAINED = os.path.join(REPO, "twoforone_tpu", "assets", "trained")
#: Where ``torch_chain10_control.py`` stages a control by default
#: (``.gitignore`` lists ``.controls/``).
TORCH_STAGED = os.path.join(REPO, ".controls", "torch_trained")
NORM_FRAMES = 400_000  # run_chain_control's n_data: the trajectory of seed 0
TRAIN_FRAMES = int(0.7 * NORM_FRAMES)


def atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def artifact_path(n_beads: int, artifact_dir: str = None) -> str:
    """The staged control's folder: ``artifact_dir``, else the JAX
    package's ``assets/trained/chain{N}``."""
    return artifact_dir or os.path.join(ASSETS_TRAINED, f"chain{n_beads}")


@functools.lru_cache(maxsize=None)
def split_norm_factor(n_beads: int) -> float:
    """``traj[:280000].std()`` of the seed-0 trajectory (``ddim_quality.py``)."""
    from twoforone_torch.data.synthetic import chain_trajectory
    from twoforone_torch.train.positive_control import chain_control_components

    traj = chain_trajectory(NORM_FRAMES, chain_control_components(n_beads), seed=0)
    return float(traj[:TRAIN_FRAMES].std())


@functools.lru_cache(maxsize=None)
def dataset_norm_factor(n_beads: int) -> float:
    """The std of the mean-centred train split, as ``run_chain_control``
    computes it (``paper_scale_langevin.py``)."""
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain_trajectory
    from twoforone_torch.train.positive_control import (
        CHAIN_CONTROL_PRESETS,
        chain_control_components,
    )

    preset = CHAIN_CONTROL_PRESETS[n_beads]
    traj = chain_trajectory(NORM_FRAMES, chain_control_components(n_beads), seed=0)
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, preset["pdb"])).topology
    trainset = CGDataset(traj[:TRAIN_FRAMES], topology, Molecules[preset["mol"]], mean0=True)
    return float(trainset.data.std())


def rebuild_control(n_beads: int, norm_factor: float, artifact_dir: str = None):
    """The staged control's ``(gd, params, components)``: the preset's model
    shape (production edges, conservative, T=1000, ``loss_weights="ones"``)
    at ``norm_factor``, with the EMA weights of ``model-best.msgpack``. The
    weights are loaded strictly into the model, so a checkpoint of another
    shape fails here. Raises ``SystemExit`` when nothing is staged."""
    from twoforone_torch.train.positive_control import (
        chain_control_components,
        chain_control_diffusion,
    )
    from twoforone_torch.utils.checkpoint import read_checkpoint
    from twoforone_torch.utils.convert import params_from_jax

    path = os.path.join(artifact_path(n_beads, artifact_dir), "model-best.msgpack")
    if not os.path.exists(path):
        raise SystemExit(f"chain{n_beads} control not staged at {os.path.dirname(path)}: "
                         "run scripts/torch_chain10_control.py first")
    gd = chain_control_diffusion(n_beads, norm_factor)
    params = read_checkpoint(path)["ema_params"]
    gd.model.load_state_dict(params_from_jax(params))
    return gd, params, chain_control_components(n_beads)


def card_label(device) -> str:
    """What a rate was measured on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or ``cpu`` for the host."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def synchronize(device) -> None:
    """Wait for the card before a clock is read (a no-op on the host)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def require_plots(no_plots: bool) -> None:
    """Stop with an error that names ``--no_plots`` when plots are asked for
    and matplotlib is absent: a run never skips its plots silently."""
    if no_plots:
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit("matplotlib is not installed: the plots cannot be drawn; "
                         "pass --no_plots to score without them")


def load_samples(path: str):
    """A ``.npy`` / ``.npz`` (first array) / ``.pt`` file of coordinates."""
    import numpy as np

    if path.endswith(".pt"):
        import torch

        return np.asarray(torch.load(path, map_location="cpu").numpy())
    arr = np.load(path)
    if isinstance(arr, np.lib.npyio.NpzFile):
        arr = arr[list(arr.keys())[0]]
    return np.asarray(arr)
