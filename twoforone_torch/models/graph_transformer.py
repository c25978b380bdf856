"""Graph-transformer score network (port of ``models/graph_transformer.py``).

Behavioral contract, the same as the JAX module:

- node features = [bead one-hot, (abs coords)?, normalized time];
- edge features = coordinate differences and/or *squared* distances, with
  ``diff[i, j] = x_j - x_i``;
- per block: PreNorm(LayerNorm, eps 1e-5) -> Attention -> GatedResidual
  (gate input ``[x, res, x - res]``), then PreNorm -> FeedForward(4x, exact
  GELU) -> GatedResidual;
- no attention mask;
- ``conservative=True`` predicts a per-node energy and forces are
  ``-torch.autograd.grad`` of the summed energy with respect to the *centred*
  coordinates (:func:`score_forward`).

Compute dtype (``dtype``), with flax's semantics: ``None`` (the default)
computes in the dtype of the parameters and the input, as the float32
network always has; a dtype such as ``torch.bfloat16`` casts at the points
where the JAX module casts. The parameters stay float32. Every dense layer
casts its input, weight and bias to ``dtype`` and returns ``dtype``
(``nn.Dense(dtype=...)``); the coordinates are cast at the model input, the
one-hot and time features are made in ``dtype``, the edge-embedding weights
and the folded edge biases are cast; LayerNorm carries no dtype, as in the
JAX module, so it takes its statistics in float32 and returns float32
(flax promotes a bfloat16 input with float32 scale and bias); the energy
comes back in float32. :meth:`GraphTransformer.with_dtype` gives the same
network at another dtype on the same parameters (flax's
``model.clone(dtype=...)``). ``torch.autocast`` is not used: its op lists
keep LayerNorm and softmax in float32 and cast at other points than flax.

Parameter names follow the flax parameter tree of the JAX module (module
path joined by dots), with torch's conventions for the leaves: ``kernel``
becomes ``weight`` stored ``(out, in)``, LayerNorm ``scale`` becomes
``weight``, and the attention's ``edges_to_kv_kernel``/``edges_to_kv_bias``
become the ``edges_to_kv`` Linear. :func:`twoforone_torch.utils.convert.params_from_jax`
maps a flax tree onto these names.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from twoforone_torch.ops.attention import edge_biased_attention, geometric_attention_heads
from twoforone_torch.ops.geometry import center_zero
from twoforone_torch.utils.convert import params_from_jax
from twoforone_torch.utils.device import float32_products, resolve_device


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer`` applied as flax's ``nn.Dense(dtype=dtype)``: input, weight and
    bias cast to ``dtype``, the product and its output in ``dtype``; ``None``
    computes in the operands' own dtype."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class GatedResidual(nn.Module):
    """Sigmoid-gated residual merge, ``x·g + res·(1 − g)`` with
    ``g = sigmoid(proj([x, res, x − res]))``.

    Computed without the concatenation: the projection's three blocks fold
    into ``x·ga + res·gh`` with ``ga = w_x + w_d`` and ``gh = w_res − w_d``
    (taken from ``proj.weight`` at each call, so gradients reach it), and the
    merge is one ``lerp``, ``res + g·(x − res)``.
    """

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(3 * dim, 1, bias=False)

    def forward(self, x, res):
        c = x.shape[-1]
        w = self.proj.weight.view(3, c)  # rows: x, res, x - res
        ga = _cast(w[0] + w[2], self.dtype)
        gh = _cast(w[1] - w[2], self.dtype)
        logit = torch.mv(x.reshape(-1, c), ga).addmv_(res.reshape(-1, c), gh)
        gate = torch.sigmoid(logit).view(*x.shape[:-1], 1)
        return torch.lerp(res, x, gate)


def _heads(t: torch.Tensor, b: int, n: int, h: int, dh: int) -> torch.Tensor:
    """(B·N, H·dh) rows -> (H, B, N, dh), heads first and contiguous: the
    attention core's batches."""
    return t.view(b * n, h, dh).transpose(0, 1).contiguous().view(h, b, n, dh)


class Attention(nn.Module):
    """Edge-biased attention over beads, geometric (production) or general
    (explicit edge tensor) path; identical math.

    The geometric path projects the rows with whole products, runs the
    attention core (:func:`geometric_attention_heads`) on (H·B, N, ·)
    batches, and returns to rows for ``to_out``: one copy into the
    head-major layout per projection and one out, and no concatenation. The
    keys and values carry their diff channel ``x_j K_diff``; the rest of the
    edge values reaches ``to_out`` through folded weights, since each row of
    attention sums to 1.
    """

    def __init__(self, dim: int, edge_dim: int, heads: int = 8, dim_head: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        self.to_q = nn.Linear(dim, inner)
        self.to_kv = nn.Linear(dim, 2 * inner)
        self.edges_to_kv = nn.Linear(edge_dim, inner)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, nodes, edges=None, geom=None):
        if geom is None:
            return self._forward_edges(nodes, edges)
        b, n, c = nodes.shape
        h, dh, dt = self.heads, self.dim_head, self.dtype
        inner = h * dh
        x, x_heads, sq_heads, w_emb, b_emb, has_diff, has_dist = geom
        rows = _cast(nodes, dt).reshape(b * n, c)
        x_rows = _cast(x.reshape(b * n, 3), dt)
        # Fold edge_embedding and edges_to_kv into one affine map of the raw
        # channels: K_comb (De, H·dh), b_comb (H·dh).
        w_e = _cast(self.edges_to_kv.weight, dt)  # (H·dh, De)
        k_comb = _cast(w_emb, dt) @ w_e.t()
        b_comb = torch.addmv(_cast(self.edges_to_kv.bias, dt), w_e, _cast(b_emb, dt))
        k_dist = k_comb[3 if has_diff else 0].view(h, dh) if has_dist else None

        # Each projection is one product over the rows (so is its weight's
        # gradient), copied once into the core's head-major layout; the
        # softmax scale rides in q's weights, and the keys and values carry
        # their diff channel x_j K_diff.
        scale = dh**-0.5
        w_kv = _cast(self.to_kv.weight, dt)
        b_k, b_v = _cast(self.to_kv.bias, dt).view(2, inner)
        q = F.linear(rows, _cast(self.to_q.weight, dt) * scale, _cast(self.to_q.bias, dt) * scale)
        k = F.linear(rows, w_kv[:inner], b_k)
        v = F.linear(rows, w_kv[inner:], b_v)
        if has_diff:
            k.addmm_(x_rows, k_comb[:3])
            v.addmm_(x_rows, k_comb[:3])
        o, f_dist = geometric_attention_heads(
            *(_heads(t, b, n, h, dh) for t in (q, k, v)), x_heads, sq_heads, k_dist
        )

        # Back to rows for to_out. Each row of attention sums to 1, so the
        # rest of the edge values reaches its output through folded weights:
        # b_comb in the bias, -x_i (K_diff W_out), f_dist_h (k_dist_h W_out_h).
        w_out = _cast(self.to_out.weight, dt)  # (C, H·dh)
        b_out = torch.addmv(_cast(self.to_out.bias, dt), w_out, b_comb)
        y = F.linear(o.view(h, b * n, dh).transpose(0, 1).reshape(b * n, inner), w_out, b_out)
        if has_diff:
            y.addmm_(x_rows, torch.mm(k_comb[:3], w_out.t()).neg_())
        if f_dist is not None:
            y.addmm_(f_dist.view(h, b * n).t(), torch.einsum("chd,hd->hc", w_out.view(c, h, dh), k_dist))
        return y.view(b, n, c)

    def _forward_edges(self, nodes, edges):
        b, n, _ = nodes.shape
        h, dh, dt = self.heads, self.dim_head, self.dtype
        q = dense(self.to_q, nodes, dt).view(b, n, h, dh)
        k, v = dense(self.to_kv, nodes, dt).chunk(2, dim=-1)
        k = k.reshape(b, n, h, dh)
        v = v.reshape(b, n, h, dh)
        w_e = _cast(self.edges_to_kv.weight.t(), dt)  # (De, inner)
        b_e = _cast(self.edges_to_kv.bias, dt)
        out = edge_biased_attention(
            q, k, v, edges, w_e.view(-1, h, dh), b_e.view(h, dh), dh**-0.5
        )
        return dense(self.to_out, out.reshape(b, n, h * dh), dt)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, dim * mult)
        self.fc2 = nn.Linear(dim * mult, dim)

    def forward(self, x):
        x = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        return dense(self.fc2, x, self.dtype)


class GraphTransformer(nn.Module):
    """Score network over (B, num_beads, 3) coordinates.

    ``forward`` expects coordinates that are already mean-centred and returns
    per-node energies (B, N, 1) in conservative mode (with
    ``return_energy=True``) or predicted noise (B, N, 3) otherwise. ``dtype``
    is the compute dtype (see the module docstring).
    """

    def __init__(
        self,
        num_beads: int,
        hidden_nf: int,
        n_layers: int = 4,
        use_intrinsic_coords: bool = False,
        use_abs_coords: bool = True,
        use_distances: bool = True,
        conservative: bool = True,
        heads: int = 8,
        dim_head: int = 64,
        use_geometric_edges: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_beads = num_beads
        self.hidden_nf = hidden_nf
        self.n_layers = n_layers
        self.use_intrinsic_coords = use_intrinsic_coords
        self.use_abs_coords = use_abs_coords
        self.use_distances = use_distances
        self.conservative = conservative
        self.heads = heads
        self.dim_head = dim_head
        self.use_geometric_edges = use_geometric_edges

        node_in = num_beads + 3 * use_abs_coords + 1
        self.node_embedding = nn.Linear(node_in, hidden_nf)
        # Holds the edge embedding's (kernel, bias); on the geometric path it
        # is folded into each layer's edge projection, never applied.
        self.edge_embedding = nn.Linear(self.edge_in_dim, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"layers_{i}_attn_norm", nn.LayerNorm(hidden_nf, eps=1e-5))
            self.add_module(
                f"layers_{i}_attn", Attention(hidden_nf, hidden_nf, heads, dim_head, dtype)
            )
            self.add_module(f"layers_{i}_attn_res", GatedResidual(hidden_nf, dtype))
            self.add_module(f"layers_{i}_ff_norm", nn.LayerNorm(hidden_nf, eps=1e-5))
            self.add_module(f"layers_{i}_ff", FeedForward(hidden_nf, dtype=dtype))
            self.add_module(f"layers_{i}_ff_res", GatedResidual(hidden_nf, dtype))
        self.node_decoder = nn.Linear(hidden_nf, 1 if conservative else 3)

    @property
    def edge_in_dim(self) -> int:
        return (
            3 * self.use_intrinsic_coords
            + self.use_distances
            + int(not self.use_intrinsic_coords and not self.use_distances)
        )

    def with_dtype(self, dtype: Optional[torch.dtype]) -> "GraphTransformer":
        """This network computing in ``dtype``, on the same parameter tensors
        (no copy; flax's ``model.clone(dtype=...)``). The modules are shallow
        copies, so a weight loaded into either is seen by both."""

        def retyped(module):
            view = copy.copy(module)
            view._modules = {name: retyped(sub) for name, sub in module._modules.items()}
            if hasattr(module, "dtype"):
                view.dtype = dtype
            return view

        return retyped(self)

    @property
    def is_production_edge_config(self) -> bool:
        """The edge configuration shared by all shipped models, which the
        fused chain-lane kernel implements."""
        return (
            self.conservative
            and self.use_intrinsic_coords
            and not self.use_abs_coords
            and not self.use_distances
        )

    def edge_features(self, x):
        """Edge attributes; distances are *squared*, ``diff[b,i,j] = x_j - x_i``."""
        diff = x[:, None, :, :] - x[:, :, None, :]
        if self.use_distances and not self.use_intrinsic_coords:
            return torch.sum(diff**2, dim=-1, keepdim=True)
        if self.use_intrinsic_coords and not self.use_distances:
            return diff
        if self.use_intrinsic_coords and self.use_distances:
            dist = torch.sum(diff**2, dim=-1, keepdim=True)
            return torch.cat([diff, dist], dim=-1)
        b, n, _ = x.shape
        return x.new_zeros((b, n, n, 1))

    def forward(self, x, t, return_energy: bool = False):
        b, n, _ = x.shape
        if n != self.num_beads:
            raise ValueError(f"expected {self.num_beads} beads, got {n}")
        dt = self.dtype
        # The coordinates in the compute dtype. The geometric edges cast
        # them again at each use, so that their gradients meet in the
        # input's dtype.
        x_in, x = x, _cast(x, dt)
        # LayerNorm has no dtype: at least float32 in, statistics and output.
        at_least_f32 = torch.promote_types(x.dtype, torch.float32)
        # The node features [one-hot, x?, t] times the embedding: the one-hot
        # picks the weight's rows, t scales its last one. Summed in the
        # product's order, then the bias, in at least float32 from operands
        # in the compute dtype, and rounded once.
        w = _cast(self.node_embedding.weight, dt).to(at_least_f32)  # (C, N + 3·abs + 1)
        bias = _cast(self.node_embedding.bias, dt).to(at_least_f32)
        t_feat = t.to(x.dtype).to(at_least_f32).view(b, 1, 1)
        nodes = torch.addcmul(w[:, :n].t().contiguous(), t_feat, w[:, -1])
        if self.use_abs_coords:
            nodes = nodes + x.to(at_least_f32) @ w[:, n:n + 3].t()
        nodes = nodes + bias
        nodes = _cast(nodes, dt)

        w_emb = self.edge_embedding.weight.t()  # (edge_in_dim, C)
        b_emb = self.edge_embedding.bias
        if self.use_geometric_edges:
            has_diff, has_dist = self.use_intrinsic_coords, self.use_distances
            x_heads = sq_heads = None
            if has_dist:
                x_heads = _cast(x_in.expand(self.heads, b, n, 3), dt).contiguous()
                sq_heads = torch.sum(x_heads * x_heads, dim=-1, keepdim=True)
            geom = (x_in, x_heads, sq_heads, w_emb, b_emb, has_diff, has_dist)
            edges = None
        else:
            geom = None
            edges = self.edge_features(x) @ _cast(w_emb, dt) + _cast(b_emb, dt)

        for i in range(self.n_layers):
            attn_in = getattr(self, f"layers_{i}_attn_norm")(nodes.to(at_least_f32))
            attn_out = getattr(self, f"layers_{i}_attn")(attn_in, edges=edges, geom=geom)
            nodes = getattr(self, f"layers_{i}_attn_res")(attn_out, nodes)
            ff_in = getattr(self, f"layers_{i}_ff_norm")(nodes.to(at_least_f32))
            ff_out = getattr(self, f"layers_{i}_ff")(ff_in)
            nodes = getattr(self, f"layers_{i}_ff_res")(ff_out, nodes)

        out = dense(self.node_decoder, nodes, dt)
        if self.conservative and not return_energy:
            raise ValueError(
                "conservative GraphTransformer outputs energies; use score_forward "
                "to obtain forces via autograd"
            )
        return out if dt is None else out.float()


def init_params(model: GraphTransformer, seed: int) -> dict:
    """Random weights for ``model`` in the flax parameter tree's layout
    (nested dicts of float32 numpy arrays, as
    :func:`twoforone_torch.utils.artifacts.load_ema_params` returns them):
    the counterpart of the JAX module's ``model.init``.

    Same keys, shapes and initializer families as flax's defaults:
    lecun-normal kernels (a normal truncated at two standard deviations with
    variance 1 / fan_in), zero biases, unit LayerNorm scales. The numbers come
    from numpy's generator seeded with ``seed``, so they are not the bits a
    JAX key would give.
    """
    rng = np.random.default_rng(seed)

    def kernel(fan_in, fan_out):
        w = rng.normal(size=(fan_in, fan_out))
        while True:  # redraw what falls outside two standard deviations
            out = np.abs(w) > 2.0
            if not out.any():
                break
            w[out] = rng.normal(size=int(out.sum()))
        # 0.8796... is the standard deviation of the truncated unit normal.
        return (w * (fan_in**-0.5 / 0.87962566103423978)).astype(np.float32)

    def dense(fan_in, fan_out, bias=True):
        d = {"kernel": kernel(fan_in, fan_out)}
        if bias:
            d["bias"] = np.zeros((fan_out,), np.float32)
        return d

    def norm(dim):
        return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}

    c, inner = model.hidden_nf, model.heads * model.dim_head
    params = {
        "node_embedding": dense(model.num_beads + 3 * model.use_abs_coords + 1, c),
        "edge_embedding": dense(model.edge_in_dim, c),
    }
    for i in range(model.n_layers):
        params[f"layers_{i}_attn_norm"] = norm(c)
        params[f"layers_{i}_attn"] = {
            "to_q": dense(c, inner),
            "to_kv": dense(c, 2 * inner),
            "edges_to_kv_kernel": kernel(c, inner),
            "edges_to_kv_bias": np.zeros((inner,), np.float32),
            "to_out": dense(inner, c),
        }
        params[f"layers_{i}_attn_res"] = {"proj": dense(3 * c, 1, bias=False)}
        params[f"layers_{i}_ff_norm"] = norm(c)
        params[f"layers_{i}_ff"] = {"fc1": dense(c, 4 * c), "fc2": dense(4 * c, c)}
        params[f"layers_{i}_ff_res"] = {"proj": dense(3 * c, 1, bias=False)}
    params["node_decoder"] = dense(c, 1 if model.conservative else 3)
    return params


def score_forward(model: GraphTransformer, x: torch.Tensor, t: torch.Tensor,
                  return_energy: bool = False, create_graph: bool = False) -> torch.Tensor:
    """Model forward in "score" convention: returns (B, N, 3) noise/forces.

    Centres the input and, in conservative mode, differentiates the summed
    per-node energy with respect to the *centred* coordinates (no projection
    afterwards), as the JAX ``score_forward`` does.

    By default the force is a value: x is detached and the graph of dE/dx is
    dropped (sampling and dynamics). ``create_graph=True`` keeps x attached
    and builds the graph of dE/dx, so that a loss on the force can be
    differentiated with respect to the weights (training).

    A network with a compute dtype runs under
    :func:`~twoforone_torch.utils.device.float32_products`, so that cuBLAS
    sums its bfloat16 products in float32; the float32 centred coordinates
    are differentiated through the cast at the model input.
    """
    with contextlib.nullcontext() if model.dtype is None else float32_products():
        return _score_forward(model, x, t, return_energy, create_graph)


def _score_forward(model, x, t, return_energy, create_graph):
    xc = center_zero(x)
    if not model.conservative:
        return model(xc, t)
    if return_energy:
        return model(xc, t, return_energy=True)
    with torch.enable_grad():
        if not create_graph:
            xc = xc.detach()
        if not xc.requires_grad:
            xc = xc.requires_grad_(True)
        energy = model(xc, t, return_energy=True).sum()
        (grad,) = torch.autograd.grad(energy, xc, create_graph=create_graph,
                                      allow_unused=True)
    if grad is None:
        # The zero-feature edge configuration without absolute coordinates has
        # an energy that does not depend on x: its force is zero.
        return torch.zeros_like(x)
    return -grad


def make_score_fn(model: GraphTransformer, params, device="cuda"):
    """Closure ``(x, t_norm) -> eps_hat`` used by the diffusion and dynamics
    loops: :func:`score_forward` of a copy of ``model`` on ``device`` with
    ``params`` (the flax parameter tree) loaded."""
    net = copy.deepcopy(model).to(resolve_device(device))
    net.load_state_dict(params_from_jax(params))
    net.eval()
    return lambda x, t_norm: score_forward(net, x, t_norm)
