"""Sampling CLI (port of ``twoforone_tpu/cli/sample.py``, same flags and
outputs, plus ``--device``).

    python -m twoforone_torch.cli.sample --model_path <results dir> --gen_mode iid|langevin
    tfo-torch-sample --model_path <results dir> ...   (the installed console script)

Two generative modes:
- ``--gen_mode iid``: batched reverse-diffusion sampling,
- ``--gen_mode langevin``: i.i.d. samples as initial states, then the
  BAOA(F)B Langevin engine with the diffusion force field at ``--noise_level``.

Reads ``config.json`` or a legacy reference ``args.pickle``, and checkpoints
in the JAX package's msgpack format or the reference's torch ``model-*.pt``.
Writes ``sample-<mode>.npy``, ``.pt`` and ``.pdb`` (the first 1000 frames)
into ``main_eval_output_<mode>[_<append_exp_name>]`` under ``--model_path``.
Runs on the card (``--device cuda``, the default, raising without CUDA) or,
with ``--device cpu``, the plain PyTorch paths on the host.

Under torchrun (``python -m torch.distributed.run --nproc_per_node K -m
twoforone_torch.cli.sample ...``) the run spans K GPUs, one process each
(:mod:`twoforone_torch.parallel.mesh`): the batch and the chains are padded
up to a multiple of K and split over the ranks, every rank gets all the
samples, and only rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.data.datasets import get_dataset
from twoforone_torch.data.molecules import (
    MASS_ALA2,
    MASS_FASTFOLDER,
    default_dt_scale,
    temp_dict,
    temp_dict_pt,
)
from twoforone_torch.data.pdb import save_pdb
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.evaluate.evaluators import sample_from_model
from twoforone_torch.models import get_model
from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed, round_to_mesh
from twoforone_torch.utils.checkpoint import read_checkpoint
from twoforone_torch.utils.config import load_config
from twoforone_torch.utils.convert import load_torch_checkpoint_as_params, params_from_jax
from twoforone_torch.utils.device import resolve_device

# --fused -> the sampler's kernel, for conservative models; "never" and the
# non-conservative models take the plain network ("xla").
SAMPLE_KERNEL = {"always": "packed", "cl": "cl", "clx": "clx", "auto": "auto"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="coarse-graining-evaluator")
    p.add_argument("--model_path", type=str, required=True,
                   help="root directory where models and config are stored")
    p.add_argument("--model_checkpoint", type=str, default="best",
                   help="best, last, 1, 2, 3, ...")
    p.add_argument("--gen_mode", type=str, default="iid",
                   help="generative mode, either iid or langevin")
    p.add_argument("--append_exp_name", type=str, default=None)
    p.add_argument("--data_folder", type=str, default=None,
                   help="if None (default) work with empty datasets and golden references")
    # i.i.d. generation
    p.add_argument("--num_samples_eval", type=int, default=1000)
    p.add_argument("--batch_size_gen", type=int, default=256)
    # Langevin simulation
    p.add_argument("--masses", type=str, default=None, help="Units in g/mol (json list)")
    p.add_argument("--friction", type=float, default=1, help="ps^-1, usually 1")
    p.add_argument("--parallel_sim", type=int, default=100)
    p.add_argument("--n_timesteps", type=int, default=10000)
    p.add_argument("--save_interval", type=int, default=250)
    p.add_argument("--noise_level", type=int, default=20,
                   help="diffusion model noise level for extracting force fields")
    p.add_argument("--dt", type=float, default=None,
                   help="ps; if None computed from the diffusion model parameters")
    p.add_argument("--dt_scale", type=float, default=None,
                   help="multiply dt (incl. auto-dt) by this; <1 trades "
                        "wall-clock for a lower BAOAB stationary bias. "
                        "Default: the measured per-protein production value "
                        "(data/molecules.default_dt_scale; villin-scale 0.5, "
                        "protein_g-scale 0.35 — the auto-dt default "
                        "measurably biases BAOAB there)")
    p.add_argument("--temp_data", type=float, default=None)
    p.add_argument("--temp_sim", type=float, default=None)
    p.add_argument("--tempering", action="store_true",
                   help="enable the tempering ramp (langevin mode): kbT starts "
                        "at --reference_temp, anneals to temp_sim, holds, and "
                        "ramps back")
    p.add_argument("--reference_temp", type=float, default=None,
                   help="tempering start/end temperature in K "
                        "(default: the per-protein temp_dict_pt table)")
    p.add_argument("--kb", type=str, default="consistent", help="consistent, kcal")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 score-net compute in the plain network: the Langevin "
                        "force where its path is the plain network, the i.i.d. chain on "
                        "--fused never; the fused kernels compute in float32")
    p.add_argument("--fused", type=str, default="never",
                   choices=["never", "auto", "cl", "clx", "always"],
                   help="force path: never | auto | cl | clx | always (cl = "
                        "the fused force kernel, N<=10; clx = the attention-"
                        "core kernel pair, 10<N<=32; always = the fused force "
                        "kernel for every edge configuration; auto picks by "
                        "model and chain count, the plain network off the GPU)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="strided DDIM reverse chain with this many score "
                        "evaluations instead of the full T (iid mode and "
                        "langevin initial states; throughput ~T/steps). "
                        "Default: full ancestral chain, reference behavior")
    p.add_argument("--ddim_eta", type=float, default=0.0,
                   help="DDIM noise scale (0 = deterministic, 1 = ancestral "
                        "noise level); only with --sample_steps")
    p.add_argument("--solver", type=str, default="ddim",
                   choices=["ddim", "dpm2m"],
                   help="strided-chain solver (with --sample_steps): ddim "
                        "or dpm2m (DPM-Solver++(2M), second-order multistep, "
                        "deterministic, ignores --ddim_eta)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; raises without CUDA) or cpu")
    return p


def load_model(model_path: str, checkpoint: str, data_folder=None, device="cuda"):
    """Rebuild ``(GaussianDiffusion, ema_params, trainset, config)`` from a
    results directory. ``ema_params`` is the flax parameter tree (nested dict
    of numpy arrays) that the port's entry points take.

    ``model-<checkpoint>.msgpack`` is read with the port's pure-Python
    reader, else ``model-<checkpoint>.pt`` through :mod:`convert`; the
    weights are loaded strictly into the model, so an architecture that does
    not fit them fails here. ``device`` is resolved first: a run meant for
    the card fails before it reads anything when CUDA is absent.
    """
    resolve_device(device)
    cfg = load_config(model_path)
    cfg.data_folder = data_folder
    trainset, _, _ = get_dataset(
        cfg.mol,
        cfg.mean0,
        data_folder,
        cfg.fold,
        shuffle_before_splitting=cfg.shuffle_data_before_splitting,
    )
    norm_factor = trainset.std if cfg.scale_data else 1.0
    model = get_model(cfg, trainset.num_beads)
    gd = GaussianDiffusion(
        model=model,
        num_atoms=trainset.num_beads,
        timesteps=cfg.diffusion_steps,
        norm_factor=norm_factor,
        loss_weights=cfg.loss_weights,
    )
    msgpack = os.path.join(model_path, f"model-{checkpoint}.msgpack")
    torch_pt = os.path.join(model_path, f"model-{checkpoint}.pt")
    if os.path.exists(msgpack):
        ema_params = read_checkpoint(msgpack)["ema_params"]
    elif os.path.exists(torch_pt):
        ema_params = load_torch_checkpoint_as_params(torch_pt, model)
    else:
        raise FileNotFoundError(f"No checkpoint {checkpoint} under {model_path}")
    model.load_state_dict(params_from_jax(ema_params))
    return gd, ema_params, trainset, cfg


def main(argv=None):
    samp_args = build_parser().parse_args(argv)
    device = resolve_device(samp_args.device)
    # A process group when torchrun's environment configures one.
    mesh = get_mesh(device) if initialize_distributed(device=device) else None
    if mesh is not None:
        device = mesh.device
    gd, ema_params, trainset, cfg = load_model(
        samp_args.model_path, samp_args.model_checkpoint, samp_args.data_folder, device
    )

    if samp_args.temp_data is None:
        samp_args.temp_data = temp_dict[cfg.mol.upper()]
    if samp_args.temp_sim is None:
        samp_args.temp_sim = temp_dict[cfg.mol.upper()]

    basic_append = f"_{samp_args.gen_mode}"
    append = (
        basic_append
        if samp_args.append_exp_name is None
        else f"{basic_append}_{samp_args.append_exp_name}"
    )
    eval_folder = Path(samp_args.model_path) / ("main_eval_output" + append)
    eval_folder.mkdir(exist_ok=True, parents=False)

    # The batch and the chains are padded up to a multiple of the mesh size,
    # so that every rank carries the same share; the padding chains are
    # simulated and then dropped.
    batch = round_to_mesh(samp_args.batch_size_gen, mesh)
    sim_requested = samp_args.parallel_sim
    sim_padded = round_to_mesh(sim_requested, mesh)
    if mesh is not None:
        print(f"Sharding over {mesh.size} devices (batch {batch}, parallel_sim {sim_padded})")
    generator = torch.Generator(device=device).manual_seed(samp_args.seed)
    # "auto" off the card is the plain network, as the JAX CLI has it on a
    # CPU host; there --bf16 applies.
    fused_mode = samp_args.fused
    if fused_mode == "auto" and device.type != "cuda":
        fused_mode = "never"
    if fused_mode != "never" and gd.model.conservative:
        # The fused reverse chain, which takes no --bf16 (as in the JAX CLI).
        sample_fn = gd.make_fused_sample_fn(
            ema_params, batch, kernel=SAMPLE_KERNEL[fused_mode],
            sample_steps=samp_args.sample_steps, eta=samp_args.ddim_eta,
            solver=samp_args.solver, device=device, mesh=mesh,
        )
    else:
        sample_fn = gd.make_sample_fn(
            ema_params, batch, sample_steps=samp_args.sample_steps, eta=samp_args.ddim_eta,
            solver=samp_args.solver, bf16=samp_args.bf16, device=device, mesh=mesh,
        )

    def sample_batch(batch_size, gen):
        return sample_fn(gen)

    sample_batch.kernel = sample_fn.kernel
    print(f"i.i.d. sampler kernel: {sample_batch.kernel}")

    if samp_args.gen_mode == "iid":
        sampled_mol = sample_from_model(
            sample_batch, samp_args.num_samples_eval, batch, generator, verbose=True
        )
    elif samp_args.gen_mode == "langevin":
        n_save = int(sim_requested * samp_args.n_timesteps / samp_args.save_interval)
        print(f"Total number of samples to save using Langevin Dynamics: {n_save}")
        # Initial states: i.i.d. samples from the same model.
        init_mol = sample_from_model(sample_batch, sim_padded, batch, generator, verbose=True)
        masses = samp_args.masses
        if masses is None:
            m = MASS_ALA2 if "alanine" in cfg.mol else MASS_FASTFOLDER
            masses = [m] * trainset.num_beads
        else:
            masses = json.loads(masses)
        dt_scale = samp_args.dt_scale
        if dt_scale is None:
            dt_scale = default_dt_scale(cfg.mol, trainset.num_beads)
            if dt_scale != 1.0:
                print(f"Using measured production dt_scale={dt_scale} for "
                      f"{cfg.mol} (override with --dt_scale)")
        sampler = LangevinDiffusion(
            gd,
            ema_params,
            init_mol,
            n_timesteps=samp_args.n_timesteps,
            save_interval=samp_args.save_interval,
            t=samp_args.noise_level,
            temp_data=samp_args.temp_data,
            temp_sim=samp_args.temp_sim,
            dt=samp_args.dt,
            dt_scale=dt_scale,
            masses=masses,
            friction=samp_args.friction,
            kb=samp_args.kb,
            random_seed=samp_args.seed,
            fused=samp_args.fused,
            bf16=samp_args.bf16,
            device=device,
            mesh=mesh,
        )
        print(f"Langevin force path: {sampler.force_fn.mode}")
        reference_temp = None
        if samp_args.tempering:
            reference_temp = (
                samp_args.reference_temp
                if samp_args.reference_temp is not None
                else temp_dict_pt[cfg.mol.upper()]
            )
            print(f"Tempering ramp enabled: reference_temp={reference_temp} K")
        sampled_mol = sampler.sample(reference_temp=reference_temp)
        if sim_padded != sim_requested:
            # Drop the padding chains (sample() is chains-major).
            sampled_mol = sampled_mol.reshape(sim_padded, -1, *sampled_mol.shape[1:])
            sampled_mol = sampled_mol[:sim_requested].reshape(-1, *sampled_mol.shape[2:])
    else:
        raise ValueError("Wrong argument 'gen_mode'")

    if mesh is not None and mesh.rank != 0:
        return sampled_mol
    np.save(str(eval_folder / f"sample-{samp_args.gen_mode}.npy"), sampled_mol)
    torch.save(
        torch.from_numpy(np.asarray(sampled_mol)),
        str(eval_folder / f"sample-{samp_args.gen_mode}.pt"),
    )
    save_pdb(
        str(eval_folder / f"sample-{samp_args.gen_mode}.pdb"),
        np.asarray(sampled_mol[:1000]),
        trainset.topology,
    )
    return sampled_mol



def console_main() -> int:
    """The ``tfo-torch-sample`` console script: :func:`main` on the command line.
    Returns 0: the script's wrapper hands the return value to ``sys.exit``,
    which would read the samples array that :func:`main` returns as a failure."""
    main()
    return 0


if __name__ == "__main__":
    main()
