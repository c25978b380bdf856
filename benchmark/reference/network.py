"""Plain PyTorch reference of the graph-transformer energy network.

Written from the published architecture (Arts et al., JCTC 2023; the
upstream ``models/graph_transformer.py``) and independent of the program:
it imports nothing of ``twoforone_torch``, ``twoforone_tpu`` or JAX, and
runs on the flax parameter tree (``{"layers_0_attn": {"to_q": {"kernel",
"bias"}, ...}}``) as plain tensors.

- node features ``[one-hot bead, t]``; edge features ``diff[i, j] = x_j -
  x_i`` (intrinsic coordinates, the configuration of every staged model)
  embedded by ``edge_embedding`` into an explicit (B, N, N, C) tensor;
- per block: LayerNorm (eps 1e-5) -> edge-biased attention, whose edge
  projection ``edges_to_kv`` is added to both keys and values, -> gated
  residual (gate over ``[x, res, x - res]``), then LayerNorm -> feed-forward
  (4x, exact GELU) -> gated residual;
- a conservative model: the energy is the sum of the per-node outputs, and
  the predicted noise is ``-dE/dx`` at the centred coordinates.

The attention is the factored form of the upstream code: the scores take
``q_i . (W_e e_ij + b_e)`` as one contraction with the explicit edge tensor,
the values take ``sum_j a_ij W_e e_ij`` the same way. Where the program
folds the edge pipeline onto the raw coordinates (its packed form, and its
kernels), this keeps the (B, N, N, C) tensor; the two agree to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

HEADS = 8
DIM_HEAD = 64


def tensors(tree, device, dtype=torch.float32) -> dict:
    """The nested parameter tree as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tensors(v, device, dtype) for k, v in tree.items()}
    return torch.tensor(np.array(tree), dtype=dtype, device=device)


def n_layers(params) -> int:
    return sum(1 for k in params if k.endswith("_attn_norm"))


def _dense(p, x):
    out = x @ p["kernel"]
    return out + p["bias"] if "bias" in p else out


def _layer_norm(p, x):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps=1e-5)


def _gated(p, x, res):
    gate = torch.sigmoid(torch.cat([x, res, x - res], dim=-1) @ p["proj"]["kernel"])
    return x * gate + res * (1.0 - gate)


def _attention(p, h, edges):
    b, n, _ = h.shape
    inner = HEADS * DIM_HEAD
    q = _dense(p["to_q"], h).view(b, n, HEADS, DIM_HEAD)
    k, v = _dense(p["to_kv"], h).split(inner, dim=-1)
    k = k.reshape(b, n, HEADS, DIM_HEAD)
    v = v.reshape(b, n, HEADS, DIM_HEAD)
    w_e = p["edges_to_kv_kernel"].view(-1, HEADS, DIM_HEAD)  # (C, H, dh)
    b_e = p["edges_to_kv_bias"].view(HEADS, DIM_HEAD)
    q_we = torch.einsum("bihd,chd->bhic", q, w_e)
    sim = (torch.einsum("bihd,bjhd->bhij", q, k)
           + torch.einsum("bhic,bijc->bhij", q_we, edges)
           + torch.einsum("bihd,hd->bhi", q, b_e)[..., None])
    attn = torch.softmax(sim * DIM_HEAD**-0.5, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, v)
    attn_e = torch.einsum("bhij,bijc->bhic", attn, edges)
    out = out + torch.einsum("bhic,chd->bihd", attn_e, w_e) + b_e
    return _dense(p["to_out"], out.reshape(b, n, inner))


def node_energies(params, x, t_norm):
    """Per-node energies (B, N) of centred coordinates ``x`` (B, N, 3) at
    normalised noise levels ``t_norm`` (B,)."""
    b, n, _ = x.shape
    onehot = torch.eye(n, dtype=x.dtype, device=x.device).expand(b, n, n)
    t_feat = t_norm.to(x.dtype).reshape(b, 1, 1).expand(b, n, 1)
    h = _dense(params["node_embedding"], torch.cat([onehot, t_feat], dim=-1))
    diff = x[:, None, :, :] - x[:, :, None, :]  # diff[b, i, j] = x_j - x_i
    edges = _dense(params["edge_embedding"], diff)
    for i in range(n_layers(params)):
        a = _attention(params[f"layers_{i}_attn"], _layer_norm(params[f"layers_{i}_attn_norm"], h),
                       edges)
        h = _gated(params[f"layers_{i}_attn_res"], a, h)
        f = _layer_norm(params[f"layers_{i}_ff_norm"], h)
        f = _dense(params[f"layers_{i}_ff"]["fc2"],
                   F.gelu(_dense(params[f"layers_{i}_ff"]["fc1"], f), approximate="none"))
        h = _gated(params[f"layers_{i}_ff_res"], f, h)
    return _dense(params["node_decoder"], h)[..., 0]


def center(x):
    return x - x.mean(dim=-2, keepdim=True)


def eps_hat(params, x, t_norm, create_graph: bool = False):
    """Predicted noise ``-dE/dx`` at the centred ``x``; ``t_norm`` a float or
    a (B,) tensor. ``create_graph`` keeps the graph for a loss on it."""
    xc = center(x)
    if not create_graph:
        xc = xc.detach()
    if not xc.requires_grad:
        xc = xc.requires_grad_(True)
    if not torch.is_tensor(t_norm):
        t_norm = torch.full((x.shape[0],), float(t_norm), dtype=x.dtype, device=x.device)
    with torch.enable_grad():
        energy = node_energies(params, xc, t_norm).sum()
        (grad,) = torch.autograd.grad(energy, xc, create_graph=create_graph)
    return -grad



def init_tree(spec: dict, generator: torch.Generator, device) -> dict:
    """Seeded random weights in the flax layout for a model of ``spec``
    (``n_beads``, ``hidden_nf``, ``n_layers``): kernels normal with variance
    1 / fan_in (lecun normal), zero biases, unit LayerNorm scales, drawn on
    ``device`` in one call and cut into leaves."""
    n, c, inner = spec["n_beads"], spec["hidden_nf"], HEADS * DIM_HEAD
    kernels = {("node_embedding", "kernel"): (n + 1, c), ("edge_embedding", "kernel"): (3, c)}
    for i in range(spec["n_layers"]):
        a = f"layers_{i}_attn"
        kernels.update({(a, "to_q", "kernel"): (c, inner), (a, "to_kv", "kernel"): (c, 2 * inner),
                        (a, "edges_to_kv_kernel"): (c, inner), (a, "to_out", "kernel"): (inner, c),
                        (f"{a}_res", "proj", "kernel"): (3 * c, 1),
                        (f"layers_{i}_ff", "fc1", "kernel"): (c, 4 * c),
                        (f"layers_{i}_ff", "fc2", "kernel"): (4 * c, c),
                        (f"layers_{i}_ff_res", "proj", "kernel"): (3 * c, 1)})
    kernels[("node_decoder", "kernel")] = (c, 1)
    total = sum(a * b for a, b in kernels.values())
    flat = torch.randn(total, generator=generator, device=device)
    tree, at = {}, 0
    for path, (fan_in, fan_out) in kernels.items():
        leaf = flat[at:at + fan_in * fan_out].view(fan_in, fan_out) * fan_in**-0.5
        at += fan_in * fan_out
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
        if path[-1] == "kernel" and path[-2] not in ("proj",):
            node["bias"] = torch.zeros(fan_out, device=device)
        elif path[-1] == "edges_to_kv_kernel":
            node["edges_to_kv_bias"] = torch.zeros(fan_out, device=device)
    for i in range(spec["n_layers"]):
        for norm in (f"layers_{i}_attn_norm", f"layers_{i}_ff_norm"):
            tree[norm] = {"scale": torch.ones(c, device=device),
                          "bias": torch.zeros(c, device=device)}
    return tree


def flat_leaves(tree, prefix=()) -> dict:
    """``{path tuple: leaf}`` of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def cosine_betas(timesteps: int) -> np.ndarray:
    """Nichol-Dhariwal cosine schedule (s = 0.008, betas clipped at 0.999):
    the betas, float64."""
    x = np.linspace(0.0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + 0.008) / 1.008 * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 0.999)


def cosine_alphas_cumprod(timesteps: int) -> np.ndarray:
    """The cosine schedule's cumulative products of 1 - beta, float64."""
    return np.cumprod(1.0 - cosine_betas(timesteps))
