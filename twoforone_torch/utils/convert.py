"""Weight carry-over between the flax parameter tree, the port's module and
the reference's torch checkpoints (port of ``twoforone_tpu/utils/convert.py``).

The flax tree (a nested dict of numpy arrays) is the one format every loader
returns: the msgpack reader (:mod:`twoforone_torch.utils.checkpoint`) and
:func:`load_torch_checkpoint_as_params` for a reference ``model-*.pt``.
:func:`params_from_jax` then carries it into the module.

**Into the port's module.** :func:`params_from_jax` maps a flax ``GraphTransformer`` parameter tree (a
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

**The reference's checkpoints.** The reference ships EMA weights inside
``model-<name>.pt`` under the "ema" key, in ema-pytorch's layout
(``ema_model.model.<graph-transformer parameters>`` plus the DDPM buffers).
:func:`torch_state_dict_to_params` maps those tensors onto the flax tree and
:func:`params_to_torch_state_dict` back:

torch key (inside ema_model.model.)                 -> flax path
---------------------------------------------------   -----------------------------------
node_embedding.{weight,bias}                          node_embedding.{kernel^T,bias}
edge_embedding.{weight,bias}                          edge_embedding.{kernel^T,bias}
node_decoder.{weight,bias}                            node_decoder.{kernel^T,bias}
graphtransformer.layers.{i}.0.0.norm.{weight,bias}    layers_{i}_attn_norm.{scale,bias}
graphtransformer.layers.{i}.0.0.fn.to_q.*             layers_{i}_attn.to_q.*
graphtransformer.layers.{i}.0.0.fn.to_kv.*            layers_{i}_attn.to_kv.*
graphtransformer.layers.{i}.0.0.fn.edges_to_kv.*      layers_{i}_attn.edges_to_kv_{kernel,bias}
graphtransformer.layers.{i}.0.0.fn.to_out.*           layers_{i}_attn.to_out.*
graphtransformer.layers.{i}.0.1.proj.0.weight         layers_{i}_attn_res.proj.kernel^T
graphtransformer.layers.{i}.1.0.norm.{weight,bias}    layers_{i}_ff_norm.{scale,bias}
graphtransformer.layers.{i}.1.0.fn.0.*                layers_{i}_ff.fc1.*
graphtransformer.layers.{i}.1.0.fn.2.*                layers_{i}_ff.fc2.*
graphtransformer.layers.{i}.1.1.proj.0.weight         layers_{i}_ff_res.proj.kernel^T

The DDPM buffers are not read: the port rebuilds them from the config.

**Out of the port's module.** :func:`params_to_jax` is the inverse of
:func:`params_from_jax`: the trainer writes its weights, its EMA and the
optimizer's moments as flax trees through it, so its checkpoints load in
the JAX package.
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


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """torch state dict -> flax parameter tree (nested dicts of float32
    numpy arrays): the inverse of :func:`params_from_jax`. Any tensors keyed
    and shaped like the state dict map the same way (the optimizer's
    moments become optax's ``mu`` and ``nu`` trees)."""
    tree: dict = {}
    for key, t in state.items():
        arr = t.detach().to("cpu", torch.float32).numpy().copy()  # not a view of t
        *mod, name = key.split(".")
        if mod[-1] == "edges_to_kv":
            mod, name = mod[:-1], f"edges_to_kv_{'kernel' if name == 'weight' else name}"
        elif name == "weight":
            name = "kernel" if arr.ndim == 2 else "scale"
        if arr.ndim == 2:
            arr = arr.T
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def _strip_prefix(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Reduce an EMA / DDPM / bare state dict to graph-transformer keys."""
    for prefix in ("ema_model.model.", "model.", ""):
        sub = {
            k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)
        }
        if any(k.startswith("node_embedding.") for k in sub):
            return {k: v for k, v in sub.items() if "." in k}
    raise ValueError("state dict does not contain graph-transformer parameters")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def torch_state_dict_to_params(state: Dict[str, np.ndarray], n_layers: int) -> dict:
    """Map a reference GraphTransformer state dict to the flax parameter tree."""
    s = {k: _np(v) for k, v in _strip_prefix(state).items()}

    def dense(key):
        return {"kernel": s[f"{key}.weight"].T, "bias": s[f"{key}.bias"]}

    def norm(key):
        return {"scale": s[f"{key}.weight"], "bias": s[f"{key}.bias"]}

    params = {
        "node_embedding": dense("node_embedding"),
        "edge_embedding": dense("edge_embedding"),
        "node_decoder": dense("node_decoder"),
    }
    for i in range(n_layers):
        base = f"graphtransformer.layers.{i}"
        params[f"layers_{i}_attn_norm"] = norm(f"{base}.0.0.norm")
        params[f"layers_{i}_attn"] = {
            "to_q": dense(f"{base}.0.0.fn.to_q"),
            "to_kv": dense(f"{base}.0.0.fn.to_kv"),
            "to_out": dense(f"{base}.0.0.fn.to_out"),
            "edges_to_kv_kernel": s[f"{base}.0.0.fn.edges_to_kv.weight"].T,
            "edges_to_kv_bias": s[f"{base}.0.0.fn.edges_to_kv.bias"],
        }
        params[f"layers_{i}_attn_res"] = {
            "proj": {"kernel": s[f"{base}.0.1.proj.0.weight"].T}
        }
        params[f"layers_{i}_ff_norm"] = norm(f"{base}.1.0.norm")
        params[f"layers_{i}_ff"] = {
            "fc1": dense(f"{base}.1.0.fn.0"),
            "fc2": dense(f"{base}.1.0.fn.2"),
        }
        params[f"layers_{i}_ff_res"] = {
            "proj": {"kernel": s[f"{base}.1.1.proj.0.weight"].T}
        }
    return params


def params_to_torch_state_dict(params: dict, n_layers: int) -> Dict[str, np.ndarray]:
    """Inverse mapping (for exporting to reference-format checkpoints)."""
    out: Dict[str, np.ndarray] = {}

    def put_dense(key, p):
        out[f"{key}.weight"] = np.asarray(p["kernel"]).T
        out[f"{key}.bias"] = np.asarray(p["bias"])

    def put_norm(key, p):
        out[f"{key}.weight"] = np.asarray(p["scale"])
        out[f"{key}.bias"] = np.asarray(p["bias"])

    put_dense("node_embedding", params["node_embedding"])
    put_dense("edge_embedding", params["edge_embedding"])
    put_dense("node_decoder", params["node_decoder"])
    for i in range(n_layers):
        base = f"graphtransformer.layers.{i}"
        put_norm(f"{base}.0.0.norm", params[f"layers_{i}_attn_norm"])
        attn = params[f"layers_{i}_attn"]
        put_dense(f"{base}.0.0.fn.to_q", attn["to_q"])
        put_dense(f"{base}.0.0.fn.to_kv", attn["to_kv"])
        put_dense(f"{base}.0.0.fn.to_out", attn["to_out"])
        out[f"{base}.0.0.fn.edges_to_kv.weight"] = np.asarray(attn["edges_to_kv_kernel"]).T
        out[f"{base}.0.0.fn.edges_to_kv.bias"] = np.asarray(attn["edges_to_kv_bias"])
        out[f"{base}.0.1.proj.0.weight"] = np.asarray(
            params[f"layers_{i}_attn_res"]["proj"]["kernel"]
        ).T
        put_norm(f"{base}.1.0.norm", params[f"layers_{i}_ff_norm"])
        put_dense(f"{base}.1.0.fn.0", params[f"layers_{i}_ff"]["fc1"])
        put_dense(f"{base}.1.0.fn.2", params[f"layers_{i}_ff"]["fc2"])
        out[f"{base}.1.1.proj.0.weight"] = np.asarray(
            params[f"layers_{i}_ff_res"]["proj"]["kernel"]
        ).T
    return out


# The registered DDPM buffers, in reference order. The reference's name for
# the timestep-sampling weights is "p2_loss_weight"; the port's buffers call
# the same array "loss_weights".
_DDPM_BUFFER_NAMES = (
    ("betas", "betas"),
    ("alphas_cumprod", "alphas_cumprod"),
    ("alphas_cumprod_prev", "alphas_cumprod_prev"),
    ("sqrt_alphas_cumprod", "sqrt_alphas_cumprod"),
    ("sqrt_one_minus_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"),
    ("log_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod"),
    ("sqrt_recip_alphas_cumprod", "sqrt_recip_alphas_cumprod"),
    ("sqrt_recipm1_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"),
    ("posterior_variance", "posterior_variance"),
    ("posterior_log_variance_clipped", "posterior_log_variance_clipped"),
    ("posterior_mean_coef1", "posterior_mean_coef1"),
    ("posterior_mean_coef2", "posterior_mean_coef2"),
    ("p2_loss_weight", "loss_weights"),
)


def build_ema_pytorch_state_dict(
    diffusion, ema_params: dict, online_params: dict = None, step: int = 0
) -> Dict[str, np.ndarray]:
    """Full ``EMA(GaussianDiffusion)`` state dict in ema-pytorch 0.0.8 layout.

    The reference sampler builds ``EMA(GaussianDiffusion)`` and loads
    ``data_dict["ema"]`` strictly, so the dict holds, beyond the EMA weights,
    the online model, every DDPM buffer under both prefixes and the
    ``initted`` / ``step`` buffers:

    - ``initted`` (shape (1,)), ``step`` (shape (1,))
    - ``{online_model,ema_model}.model.<net key>`` for every score-net tensor
    - ``{online_model,ema_model}.<buffer>`` for the 13 DDPM buffers

    ``online_params`` defaults to the EMA weights (the reference sampler only
    reads ``ema_model.*``).
    """
    n_layers = diffusion.model.n_layers
    nets = {
        "online_model": params_to_torch_state_dict(
            ema_params if online_params is None else online_params, n_layers
        ),
        "ema_model": params_to_torch_state_dict(ema_params, n_layers),
    }
    buffers = {
        torch_name: _np(getattr(diffusion.buffers, ours))
        for torch_name, ours in _DDPM_BUFFER_NAMES
    }
    out: Dict[str, np.ndarray] = {
        "initted": np.asarray([True]),
        "step": np.asarray([int(step)], dtype=np.int64),
    }
    for prefix, net in nets.items():
        for k, v in net.items():
            out[f"{prefix}.model.{k}"] = v
        for k, v in buffers.items():
            out[f"{prefix}.{k}"] = v
    return out


def load_torch_checkpoint_as_params(path: str, model) -> dict:
    """Load a reference ``model-*.pt`` and return its EMA weights as the flax
    parameter tree. The file is unpickled in full (``weights_only=False``),
    as the reference's own sampler does: load only checkpoints you trust."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    state = data["ema"] if isinstance(data, dict) and "ema" in data else data
    return torch_state_dict_to_params(state, model.n_layers)
