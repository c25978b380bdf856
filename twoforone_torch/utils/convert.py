"""Weight carry-over from the JAX package's flax parameter tree.

:func:`params_from_jax` maps a flax ``GraphTransformer`` parameter tree (a
nested dict of numpy arrays, as :mod:`twoforone_torch.utils.checkpoint`
reads it) onto the state dict of the port's
:class:`twoforone_torch.models.graph_transformer.GraphTransformer`. The
port keeps the flax tree names; only the leaves change:

flax path                                   -> torch state-dict key
-----------------------------------------      ---------------------------------------
<module>.kernel  (Dense, (in, out))            <module>.weight  (Linear, (out, in))
<module>.bias                                  <module>.bias
layers_{i}_{attn,ff}_norm.scale                layers_{i}_{attn,ff}_norm.weight
layers_{i}_attn.edges_to_kv_kernel             layers_{i}_attn.edges_to_kv.weight (transposed)
layers_{i}_attn.edges_to_kv_bias               layers_{i}_attn.edges_to_kv.bias
layers_{i}_{attn,ff}_res.proj.kernel           layers_{i}_{attn,ff}_res.proj.weight (transposed)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """flax parameter tree (nested dict of numpy arrays) -> torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        *mod, name = path
        if name == "edges_to_kv_kernel":
            mod, name = mod + ["edges_to_kv"], "kernel"
        elif name == "edges_to_kv_bias":
            mod, name = mod + ["edges_to_kv"], "bias"
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        out[".".join(mod + [name])] = torch.tensor(arr)
    return out
