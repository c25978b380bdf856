"""Score-network registry (port of ``twoforone_tpu/models/__init__.py``)."""

import torch

from twoforone_torch.models.graph_transformer import (  # noqa: F401
    GraphTransformer,
    score_forward,
    make_score_fn,
)

# Reference flags that never reach the GraphTransformer constructor. The
# reference parses them but drops them, which would silently train another
# model than asked; non-default values are refused instead. Every shipped
# config carries exactly these defaults, so legacy checkpoints still load.
_UNPLUMBED_FLAG_DEFAULTS = {
    "use_layernorm": True,
    "use_rbf": False,
    "residual_edge": True,
    "graph_mlp_decoder": False,
    "gnn_efficient": False,
    "sum_energies": True,
}


def get_model(config, num_beads: int) -> GraphTransformer:
    """Build the score network from a training config.

    ``config`` is anything with the reference flag names as attributes
    (TrainConfig, argparse Namespace, or a legacy args.pickle namespace).
    ``bf16=True`` builds a network that computes in bfloat16 on float32
    parameters, as the JAX package's does.
    """
    backbone = getattr(config, "backbone_network", "graph-transformer")
    if backbone != "graph-transformer":
        raise ValueError(f"Network {backbone} not implemented")
    bad = {
        name: getattr(config, name)
        for name, default in _UNPLUMBED_FLAG_DEFAULTS.items()
        if getattr(config, name, default) != default
    }
    if bad:
        raise ValueError(
            f"Model flags {bad} are accepted for CLI parity with the "
            "reference (main_train.py) but are not plumbed into the graph "
            "transformer there or here; refusing to silently train a "
            "different model than asked. Use the defaults "
            f"{ {k: _UNPLUMBED_FLAG_DEFAULTS[k] for k in bad} } instead."
        )
    return GraphTransformer(
        num_beads=num_beads,
        hidden_nf=config.hidden_features_gnn,
        n_layers=config.num_layers_gnn,
        use_intrinsic_coords=config.use_intrinsic_coords,
        use_abs_coords=config.use_abs_coords,
        use_distances=config.use_distances,
        conservative=config.conservative,
        dtype=torch.bfloat16 if getattr(config, "bf16", False) else None,
    )
