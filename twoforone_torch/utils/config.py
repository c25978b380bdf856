"""Experiment configuration: a typed dataclass in place of args.pickle (copy
of ``twoforone_tpu/utils/config.py``).

- keeps the reference's flag names for CLI parity,
- serializes to JSON (config.json) instead of pickle,
- tolerates unknown or extra keys on load, keeping them in ``extra``,
- converts legacy args.pickle files (:func:`load_legacy_args_pickle`).

Every field of the JAX package's config is kept, so a ``config.json``
written by either package reads the same in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TrainConfig:
    # Molecule / data
    mol: str = "alanine_dipeptide_fuberlin"
    fold: int = 1
    data_folder: Optional[str] = "./data"
    results_folder: str = "./results"
    tensorboard_folder: str = "./runs"
    experiment_name: str = "debug"
    traindata_subset: Optional[int] = None
    mean0: bool = True
    data_aug: bool = True
    scale_data: bool = True
    shuffle_data_before_splitting: bool = False

    # Score network
    backbone_network: str = "graph-transformer"
    hidden_features_gnn: int = 256
    num_layers_gnn: int = 3
    use_layernorm: bool = True
    conservative: bool = True
    use_intrinsic_coords: bool = False
    use_abs_coords: bool = True
    use_distances: bool = True
    use_rbf: bool = False
    r_max: Optional[float] = None
    residual_edge: bool = True
    graph_mlp_decoder: bool = False
    gnn_efficient: bool = False
    sum_energies: bool = True

    # Diffusion
    diffusion_steps: int = 1000
    loss_weights: str = "ones"
    t_diff_interval: Optional[list] = None

    # Optimization
    batch_size: int = 256
    # Micro-batches accumulated per optimizer step (reference trainer.py:40,
    # :246-258 — hardcoded to 1 in main_train.py:330; exposed as a flag here).
    gradient_accumulate_every: int = 1
    # Optimizer steps per host dispatch in the JAX trainer (a device-side
    # loop); eval cadence rounds to chunk boundaries.
    steps_per_host_loop: int = 1
    learning_rate: float = 2e-4
    weight_decay: float = 1e-12
    train_iter: int = 2500000
    ema_decay: float = 0.995
    min_lr_cosine_anneal: Optional[float] = 1e-5
    iterations_on_val: float = 5

    # Eval / checkpointing cadence
    eval_interval: int = 100000
    log_tensorboard_interval: int = 1
    num_samples: int = 5000
    num_samples_final_eval: int = 400000
    pick_checkpoint: str = "best"
    start_from_last_saved: bool = False
    save_all_checkpoints: bool = False

    # Langevin eval
    eval_langevin: bool = False
    langevin_timesteps: int = 1000000
    langevin_stepsize: float = 2e-3
    langevin_t_diff: List[int] = field(default_factory=lambda: [12])

    # Extensions without a reference equivalent
    bf16: bool = False  # bfloat16 score-net compute on float32 parameters (get_model)
    seed: int = 0
    ala2_train_cap: int = 500000  # reference hardcodes 500k (dataset_utils_empty.py:98)
    profile_steps: int = 0  # >0: profile that many training steps

    def __post_init__(self):
        if "alanine_dipeptide" in self.mol.lower():
            self.shuffle_data_before_splitting = False
        else:
            self.shuffle_data_before_splitting = True

    # -- serialization --------------------------------------------------------
    def to_json(self, path: str) -> None:
        """Write through a file of this process and an atomic rename (the
        ranks of a data-parallel run may share the folder)."""
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        cfg.extra = unknown  # preserved, not interpreted
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_legacy_args_pickle(path: str) -> TrainConfig:
    """Convert a reference args.pickle (argparse Namespace, possibly holding
    torch objects like ``Tanh()``) into a TrainConfig, ignoring unknown keys."""
    from twoforone_torch.evaluate.deeptime_compat import DuckUnpickler

    with open(path, "rb") as f:
        ns = DuckUnpickler(f).load()
    d = dict(vars(ns))
    # Drop non-JSON-able legacy objects (e.g. activation=Tanh()).
    clean = {}
    for k, v in d.items():
        if isinstance(v, (int, float, str, bool, list, tuple, type(None))):
            clean[k] = list(v) if isinstance(v, tuple) else v
    return TrainConfig.from_dict(clean)


def load_config(model_path: str) -> TrainConfig:
    """Load a training config from a results dir: config.json preferred,
    legacy args.pickle supported."""
    json_path = os.path.join(model_path, "config.json")
    if os.path.exists(json_path):
        return TrainConfig.from_json(json_path)
    pickle_path = os.path.join(model_path, "args.pickle")
    if os.path.exists(pickle_path):
        return load_legacy_args_pickle(pickle_path)
    raise FileNotFoundError(f"No config.json or args.pickle under {model_path}")
