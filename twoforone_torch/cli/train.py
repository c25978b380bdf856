"""Training CLI (port of ``twoforone_tpu/cli/train.py``: the same flags,
plus ``--device``).

    python -m twoforone_torch.cli.train --mol chignolin --data_folder <dir> ... [--device cpu]
    tfo-torch-train --mol chignolin ...   (the installed console script)

Boolean flags take true/false strings. ``--mol alanine_dipeptide`` means
``alanine_dipeptide_fuberlin``, as in the JAX CLI. Runs on the card
(``--device cuda``, the default, raising without CUDA) or, with ``--device
cpu``, on the host. The JAX CLI's compile cache has no counterpart.

Data-parallel training runs one process per GPU
(:mod:`twoforone_torch.parallel.mesh`). Under torchrun (``python -m
torch.distributed.run --nproc_per_node K -m twoforone_torch.cli.train ...``)
the environment configures the process group and the same command spans K
GPUs. Across hosts, ``--multihost true --coordinator_address host0:port
--num_processes W --process_id r`` configures it explicitly; with nothing
configured ``--multihost true`` is a logged no-op.
"""

from __future__ import annotations

import argparse

from twoforone_torch.data.molecules import all_molecules
from twoforone_torch.utils.config import TrainConfig


def _bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v}")


def _optional(type_):
    def parse(v):
        return None if v in ("None", "none", "null") else type_(v)

    return parse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="coarse-graining")
    d = TrainConfig()
    p.add_argument("--mol", type=str, default="alanine_dipeptide",
                   help=f"Select molecule, choose from (case insensitive): {all_molecules}")
    p.add_argument("--fold", type=int, default=d.fold,
                   help="Fold from [1,2,3,4] for four-fold cross validation. Only for alanine_dipeptide")
    p.add_argument("--data_folder", type=str, default="./data")
    p.add_argument("--results_folder", type=str, default="./results")
    p.add_argument("--tensorboard_folder", type=str, default="./runs")
    p.add_argument("--experiment_name", type=str, default="debug")
    p.add_argument("--traindata_subset", type=_optional(int), default=None)
    p.add_argument("--mean0", type=_bool, default=d.mean0)
    p.add_argument("--data_aug", type=_bool, default=d.data_aug)
    p.add_argument("--hidden_features_gnn", type=int, default=d.hidden_features_gnn)
    p.add_argument("--num_layers_gnn", type=int, default=d.num_layers_gnn)
    p.add_argument("--use_layernorm", type=_bool, default=d.use_layernorm)
    p.add_argument("--conservative", type=_bool, default=d.conservative)
    p.add_argument("--diffusion_steps", type=int, default=d.diffusion_steps)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--gradient_accumulate_every", type=int,
                   default=d.gradient_accumulate_every,
                   help="micro-batches accumulated per optimizer step")
    p.add_argument("--steps_per_host_loop", type=int,
                   default=d.steps_per_host_loop,
                   help="optimizer steps per chunk; >1 rounds eval_interval down to a"
                        " chunk multiple and logs the train loss at chunk granularity")
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--train_iter", type=int, default=d.train_iter)
    p.add_argument("--ema_decay", type=float, default=d.ema_decay)
    p.add_argument("--eval_interval", type=int, default=d.eval_interval)
    p.add_argument("--log_tensorboard_interval", type=int, default=d.log_tensorboard_interval)
    p.add_argument("--num_samples", type=int, default=d.num_samples)
    p.add_argument("--num_samples_final_eval", type=int, default=d.num_samples_final_eval)
    p.add_argument("--use_intrinsic_coords", type=_bool, default=d.use_intrinsic_coords)
    p.add_argument("--use_abs_coords", type=_bool, default=d.use_abs_coords)
    p.add_argument("--use_distances", type=_bool, default=d.use_distances)
    p.add_argument("--use_rbf", type=_bool, default=d.use_rbf)
    p.add_argument("--r_max", type=_optional(float), default=None)
    p.add_argument("--residual_edge", type=_bool, default=d.residual_edge)
    p.add_argument("--graph_mlp_decoder", type=_bool, default=d.graph_mlp_decoder)
    p.add_argument("--gnn_efficient", type=_bool, default=d.gnn_efficient)
    p.add_argument("--min_lr_cosine_anneal", type=_optional(float), default=d.min_lr_cosine_anneal)
    p.add_argument("--eval_langevin", type=_bool, default=d.eval_langevin)
    p.add_argument("--langevin_timesteps", type=int, default=d.langevin_timesteps)
    p.add_argument("--langevin_stepsize", type=float, default=d.langevin_stepsize)
    p.add_argument("--langevin_t_diff", type=int, nargs="+", default=d.langevin_t_diff)
    p.add_argument("--scale_data", type=_bool, default=d.scale_data)
    p.add_argument("--pick_checkpoint", type=str, default=d.pick_checkpoint)
    p.add_argument("--start_from_last_saved", type=_bool, default=d.start_from_last_saved)
    p.add_argument("--iterations_on_val", type=float, default=d.iterations_on_val)
    p.add_argument("--sum_energies", type=_bool, default=d.sum_energies)
    p.add_argument("--t_diff_interval", type=str, default=None, help="[0,100], None")
    p.add_argument("--loss_weights", type=str, default=d.loss_weights,
                   help="ones, score_matching, higheruntil_30, higheruntil_100, lower_bound_1000")
    p.add_argument("--save_all_checkpoints", type=_bool, default=d.save_all_checkpoints)
    p.add_argument("--bf16", type=_bool, default=False, help="bfloat16 score-net compute")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ala2_train_cap", type=int, default=500000)
    p.add_argument("--multihost", type=_bool, default=False,
                   help="join a multi-process job through --coordinator_address, "
                        "--num_processes and --process_id (torchrun's environment "
                        "needs no flag); a no-op when nothing is configured")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 of a multi-process job")
    p.add_argument("--num_processes", type=_optional(int), default=None)
    p.add_argument("--process_id", type=_optional(int), default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; raises without CUDA) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    d = dict(vars(args))
    if isinstance(d.get("t_diff_interval"), str):
        import json

        d["t_diff_interval"] = (
            None if d["t_diff_interval"] in (None, "None") else json.loads(d["t_diff_interval"])
        )
    if d["mol"].lower() == "alanine_dipeptide":
        d["mol"] = "alanine_dipeptide_fuberlin"
    return TrainConfig.from_dict(d)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed
    from twoforone_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.multihost:
        started = initialize_distributed(args.coordinator_address, args.num_processes,
                                         args.process_id, device=device)
    else:  # torchrun's environment, else a no-op
        started = initialize_distributed(device=device)
    mesh = get_mesh(device) if started else None
    if mesh is not None:
        print(f"multihost: process {mesh.rank}/{mesh.size}, {mesh.size} global devices")
    elif args.multihost:
        print("multihost: no coordinator configured; single-process run")
    cfg = config_from_args(args)
    print(cfg)

    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.data.datasets import get_dataset
    from twoforone_torch.models import get_model
    from twoforone_torch.train.trainer import Trainer

    trainset, valset, testset = get_dataset(
        cfg.mol,
        cfg.mean0,
        cfg.data_folder,
        cfg.fold,
        traindata_subset=cfg.traindata_subset,
        shuffle_before_splitting=cfg.shuffle_data_before_splitting,
        ala2_train_cap=cfg.ala2_train_cap,
    )
    norm_factor = trainset.std if cfg.scale_data else 1.0
    model = get_model(cfg, trainset.num_beads)
    print(model)
    gd = GaussianDiffusion(
        model=model,
        num_atoms=trainset.num_beads,
        timesteps=cfg.diffusion_steps,
        norm_factor=norm_factor,
        loss_weights=cfg.loss_weights,
        t_diff_interval=(
            None if cfg.t_diff_interval is None else tuple(cfg.t_diff_interval)
        ),
    )
    trainer = Trainer(gd, (trainset, valset, testset), cfg.mol, cfg, mesh=mesh,
                      device=device)
    trainer.train()
    return trainer



def console_main() -> int:
    """The ``tfo-torch-train`` console script: :func:`main` on the command line.
    Returns 0: the script's wrapper hands the return value to ``sys.exit``,
    which would read the trainer that :func:`main` returns as a failure."""
    main()
    return 0


if __name__ == "__main__":
    main()
