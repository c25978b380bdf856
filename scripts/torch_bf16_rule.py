"""Where the constants of ``tests/test_torch_bf16.py``'s rule come from.

    python3 scripts/torch_bf16_rule.py
    XLA_FLAGS=--xla_allow_excess_precision=false python3 scripts/torch_bf16_rule.py

For 24 small networks (N=5, nf 32, 2 layers, 2 x 8 heads; the four edge
configurations, both attention paths, three JAX init seeds) it evaluates the
forces of the JAX network in float32 and at ``clone(dtype=jnp.bfloat16)``
and of the port's network at ``with_dtype(torch.bfloat16)`` on the same
inputs, on the CPU, and prints one JSON line per network with the ratio
``max|port_bf16 - jax_bf16| / max|jax_bf16 - jax_f32|`` and a last line with
the smallest and largest ratio. With XLA's excess precision off (the second
form) XLA rounds after every bfloat16 operation, as PyTorch does.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT  # noqa: E402
from twoforone_tpu.models.graph_transformer import score_forward as jscore  # noqa: E402
from twoforone_torch.models.graph_transformer import GraphTransformer, score_forward  # noqa: E402
from twoforone_torch.utils.convert import params_from_jax  # noqa: E402

EDGE_CONFIGS = [(True, False, False), (False, True, True), (True, True, True),
                (False, False, True)]  # (use_intrinsic_coords, use_distances, use_abs_coords)


def main():
    ratios = []
    for geometric in (True, False):
        for intrinsic, distances, abs_coords in EDGE_CONFIGS:
            kw = dict(use_intrinsic_coords=intrinsic, use_distances=distances,
                      use_abs_coords=abs_coords, use_geometric_edges=geometric)
            for seed in range(3):
                jm = JGT(num_beads=5, hidden_nf=32, n_layers=2, heads=2, dim_head=8, **kw)
                jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 5, 3)), jnp.zeros((1,)),
                             return_energy=True)["params"]
                rng = np.random.default_rng(seed)
                x = rng.normal(size=(8, 5, 3)).astype(np.float32)
                t = rng.uniform(size=(8,)).astype(np.float32)
                jax32 = np.asarray(jax.jit(lambda p, x, t: jscore(jm, p, x, t))(jp, x, t))
                jb = jm.clone(dtype=jnp.bfloat16)
                jax16 = np.asarray(jax.jit(lambda p, x, t: jscore(jb, p, x, t))(jp, x, t))
                model = GraphTransformer(5, 32, 2, heads=2, dim_head=8, **kw)
                model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
                port16 = score_forward(model.with_dtype(torch.bfloat16), torch.from_numpy(x),
                                       torch.from_numpy(t)).numpy()
                ratio = float(np.abs(port16 - jax16).max() / np.abs(jax16 - jax32).max())
                ratios.append(ratio)
                print(json.dumps(dict(geometric=geometric, **kw, seed=seed,
                                      max_abs_force=float(np.abs(jax32).max()),
                                      ratio=ratio)), flush=True)
    print(json.dumps(dict(networks=len(ratios), min_ratio=min(ratios),
                          max_ratio=max(ratios))), flush=True)


if __name__ == "__main__":
    main()
