"""Fused conservative force evaluation for every edge configuration: one
CUDA kernel per force call.

Port of ``twoforone_tpu/ops/fused_score.py::make_fused_force_kernel`` (the
head-packed Pallas kernel). One call computes, for every chain,

    eps_hat = -dE/dx_c,   x_c = x - mean_beads(x),

where E is the summed per-node energy of the conservative
``GraphTransformer`` at normalized noise level ``t``, for any of the four
edge configurations (intrinsic coordinates and/or squared distances, or
neither) with or without absolute coordinates in the node features. The whole
energy forward and its backward (input gradients only) run inside one launch
of ``csrc/fused_score.cu``; the gradient is taken with respect to the
*centred* coordinates with no projection afterwards, as in the JAX kernel.
``t`` is a kernel argument, so the fixed-t form (Langevin) and the runtime-t
form (the reverse chain) are the same kernel.

The JAX module packs the heads along the sequence axis, splits the weights
per head host-side, pads the chains to a block and rematerializes layers:
answers to the TPU's compiler and matrix unit. The port computes the
function, not the packing: plain per-head attention over N keys, any number
of chains, no padding, f32 throughout (the TPU kernel's default is a bf16
matrix pass).

Pieces:

- :func:`augment_params` folds the flax weights host-side into the kernel's
  layout;
- :func:`fused_force_reference` is the plain PyTorch version, an eager
  transcription of the JAX module's ``_energy_forward`` differentiated with
  autograd;
- :func:`fused_force` is the kernel wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor launches the kernel or raises;
- :func:`make_fused_force_kernel` is the JAX factory's counterpart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from twoforone_torch.ops import _build
from twoforone_torch.ops.tile_plan import plan_tiles
from twoforone_torch.utils.device import resolve_device, sm_count

# Limits of csrc/fused_score.cu (``fused_force_launch`` refuses the rest):
# bead count, and widths that are multiples of 4 (16-byte rows).
MAX_N = 64


def layer_order(intrinsic: bool, distances: bool) -> tuple:
    """Per-layer weight order in the kernel's flat buffer (csrc/fused_score.cu,
    ``layer_weights``). Matrices are (in, out) row-major; the ``*T`` copies
    are their (out, in) transposes, read by the backward's input-gradient
    products. ``wqkv`` is [wq | wk | wv] (C, 3 inner) with ``bqkv`` its bias,
    so that the three input projections are one product, and ``wqkvT`` its
    transpose (the three transposes stacked). ``kc`` (3, inner) is there with
    intrinsic coordinates, ``kd`` (inner,) with distances."""
    edge = (("kc",) if intrinsic else ()) + (("kd",) if distances else ())
    return (
        "ln1_g", "ln1_b", "wqkv", "bqkv", *edge, "wo", "bo",
        "ga1", "gh1", "ln2_g", "ln2_b", "w1", "b1", "w2", "b2", "ga2", "gh2",
        "wqkvT", "woT", "w1T", "w2T",
    )


def global_order(abs_coords: bool) -> tuple:
    """Order of the weights that follow the layers: ``wx`` (3, C) is there
    with absolute coordinates."""
    return ("h0", *(("wx",) if abs_coords else ()), "wt", "wdec", "bdec")


@dataclass
class Folded:
    """Folded weights of one model: the tensors the plain version reads and
    the flat buffer the kernel reads, on one device."""

    n: int
    c: int
    heads: int
    dh: int
    ff: int
    intrinsic: bool
    distances: bool
    abs_coords: bool
    layers: list  # per-layer dicts of tensors
    glob: dict  # h0 (N, C), wx (3, C) or absent, wt (C,), wdec (C,), bdec (1,)
    flat: torch.Tensor  # kernel layout, 1-D float32
    checked: bool = False  # the flat buffer's size was held against the library

    @property
    def inner(self) -> int:
        return self.heads * self.dh

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def augment_params(model, params, device="cuda", dtype=torch.float32) -> Folded:
    """Host-side weight folding (port of ``_augment_params`` without the
    per-head splits).

    ``model`` describes the architecture (any object with ``num_beads``,
    ``hidden_nf``, ``n_layers``, ``heads``, ``dim_head`` and the edge flags,
    e.g. the port's ``GraphTransformer``); ``params`` is the flax parameter
    tree as nested dicts of numpy arrays (from
    :func:`twoforone_torch.utils.artifacts.load_ema_params`, from
    :func:`twoforone_torch.models.graph_transformer.init_params`, or the JAX
    package's ``model.init`` converted leaf by leaf with ``np.asarray``).

    Folds:

    - the node embedding into ``h0 + x_c @ wx + t * wt``: features are
      ``[one-hot, (x_c), t]``, so the embedded nodes are a constant (N, C)
      map, plus the coordinate rows ``N:N+3`` with absolute coordinates, plus
      t times the last row;
    - per layer, the edge pipeline into ``k_comb = W_emb @ W_e`` and
      ``bc = b_emb @ W_e + b_e``: ``kc`` is its first three rows with
      intrinsic coordinates, ``kd`` the row of the distance channel (row 3
      with intrinsic coordinates, else row 0); the zero-feature configuration
      keeps only ``bc``, whose value side the kernel reads as
      ``bo = bc @ W_out + b_out``;
    - each gated residual's ``[x, res, x - res]`` projection into
      ``x·ga + res·gh`` with ``ga = w_x + w_d``, ``gh = w_res - w_d``.

    ``dtype`` is the type of the tensors the plain version reads
    (``torch.float64`` makes :func:`fused_force_reference` a ground truth for
    float64 coordinates); the kernel's flat buffer is float32 always.
    """
    if not model.conservative:
        raise ValueError("the fused force kernel implements the conservative path")
    p = params
    f32 = lambda a: np.asarray(a, np.float32)
    n, c = model.num_beads, model.hidden_nf
    heads, dh = model.heads, model.dim_head
    inner = heads * dh
    intrinsic, distances = bool(model.use_intrinsic_coords), bool(model.use_distances)
    abs_coords = bool(model.use_abs_coords)

    w_emb = f32(p["edge_embedding"]["kernel"])  # (edge_in_dim, De)
    b_emb = f32(p["edge_embedding"]["bias"])
    wn = f32(p["node_embedding"]["kernel"])  # (N + 3 * abs + 1, C)
    if wn.shape[0] != n + 3 * abs_coords + 1:
        raise ValueError(
            f"node embedding has {wn.shape[0]} rows, the model's flags ask for "
            f"{n + 3 * abs_coords + 1}"
        )
    glob = {
        "h0": wn[:n] + f32(p["node_embedding"]["bias"])[None, :],  # (N, C)
        "wt": wn[-1],  # (C,)
        "wdec": f32(p["node_decoder"]["kernel"])[:, 0],
        "bdec": f32(p["node_decoder"]["bias"]).reshape(1),
    }
    if abs_coords:
        glob["wx"] = wn[n:n + 3]  # (3, C)

    def gate(proj):
        w = f32(proj["kernel"])[:, 0]  # (3C,) over [x, res, x - res]
        return w[:c] + w[2 * c:], w[c:2 * c] - w[2 * c:]

    layers = []
    for i in range(model.n_layers):
        attn = p[f"layers_{i}_attn"]
        w_e = f32(attn["edges_to_kv_kernel"])  # (De, inner)
        k_comb = w_emb @ w_e  # (edge_in_dim, inner)
        bc = b_emb @ w_e + f32(attn["edges_to_kv_bias"])  # (inner,)
        wo = f32(attn["to_out"]["kernel"])  # (inner, C)
        wkv = f32(attn["to_kv"]["kernel"])
        bkv = f32(attn["to_kv"]["bias"])
        ff = p[f"layers_{i}_ff"]
        ga1, gh1 = gate(p[f"layers_{i}_attn_res"]["proj"])
        ga2, gh2 = gate(p[f"layers_{i}_ff_res"]["proj"])
        d = {
            "ln1_g": f32(p[f"layers_{i}_attn_norm"]["scale"]),
            "ln1_b": f32(p[f"layers_{i}_attn_norm"]["bias"]),
            "wq": f32(attn["to_q"]["kernel"]),
            "bq": f32(attn["to_q"]["bias"]),
            "wk": wkv[:, :inner], "bk": bkv[:inner],
            "wv": wkv[:, inner:], "bv": bkv[inner:],
            "bc": bc,
            "wo": wo,
            "b_out": f32(attn["to_out"]["bias"]),
            "bo": bc @ wo + f32(attn["to_out"]["bias"]),  # b_out_total
            "ga1": ga1, "gh1": gh1,
            "ln2_g": f32(p[f"layers_{i}_ff_norm"]["scale"]),
            "ln2_b": f32(p[f"layers_{i}_ff_norm"]["bias"]),
            "w1": f32(ff["fc1"]["kernel"]), "b1": f32(ff["fc1"]["bias"]),
            "w2": f32(ff["fc2"]["kernel"]), "b2": f32(ff["fc2"]["bias"]),
            "ga2": ga2, "gh2": gh2,
        }
        if intrinsic:
            d["kc"] = k_comb[:3]  # (3, inner)
        if distances:
            d["kd"] = k_comb[3 if intrinsic else 0]  # (inner,)
        d["wqkv"] = np.concatenate([d["wq"], d["wk"], d["wv"]], axis=1)
        d["bqkv"] = np.concatenate([d["bq"], d["bk"], d["bv"]])
        for name in ("wqkv", "wo", "w1", "w2"):
            d[name + "T"] = d[name].T
        layers.append(d)

    flat = np.concatenate(
        [np.ravel(d[k]) for d in layers for k in layer_order(intrinsic, distances)]
        + [np.ravel(glob[k]) for k in global_order(abs_coords)]
    ).astype(np.float32)
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    return Folded(
        n=n, c=c, heads=heads, dh=dh, ff=layers[0]["w1"].shape[1],
        intrinsic=intrinsic, distances=distances, abs_coords=abs_coords,
        layers=[{k: to_t(v).to(dtype) for k, v in d.items()
                 if not k.endswith("T") and "qkv" not in k} for d in layers],
        glob={k: to_t(v).to(dtype) for k, v in glob.items()},
        flat=to_t(flat),
    )


def _layer_norm(h, g, b, eps=1e-5):
    mean = h.mean(dim=-1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * g + b


def _energy(xc, t, fw: Folded):
    """Summed energy of all chains: transcription of ``_energy_forward`` (the
    loop-over-heads body of the JAX module), with the heads as a tensor axis.
    xc: (B, N, 3) centred coordinates; ``t`` a float or a 0-d tensor."""
    bsz, n, _ = xc.shape
    heads, dh = fw.heads, fw.dh
    scale = dh**-0.5
    t = t if torch.is_tensor(t) else float(t)
    h = fw.glob["h0"] + t * fw.glob["wt"]  # (N, C)
    h = h.expand(bsz, n, fw.c)
    if fw.abs_coords:
        h = h + xc @ fw.glob["wx"]
    if fw.distances:
        sq = (xc * xc).sum(dim=-1)  # (B, N)
        gram = xc @ xc.transpose(1, 2)  # (B, N, N)
        dist = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    for d in fw.layers:
        hl = _layer_norm(h, d["ln1_g"], d["ln1_b"])
        q = (hl @ d["wq"] + d["bq"]).view(bsz, n, heads, dh)
        k = (hl @ d["wk"] + d["bk"]).view(bsz, n, heads, dh)
        v = (hl @ d["wv"] + d["bv"]).view(bsz, n, heads, dh)
        bc = d["bc"].view(heads, dh)
        sim = torch.einsum("bihd,bjhd->bhij", q, k)
        sim = sim + torch.einsum("bihd,hd->bhi", q, bc)[..., None]  # q . b_comb
        if fw.intrinsic:
            kc = d["kc"].view(3, heads, dh)
            q_kd = torch.einsum("bihd,chd->bhic", q, kc)  # (B, H, N, 3)
            sim = sim + torch.einsum("bhic,bjc->bhij", q_kd, xc)
            sim = sim - (q_kd * xc[:, None]).sum(dim=-1)[..., None]
        if fw.distances:
            kd = d["kd"].view(heads, dh)
            q_ks = torch.einsum("bihd,hd->bhi", q, kd)
            sim = sim + q_ks[..., None] * dist[:, None]
        attn = torch.softmax(scale * sim, dim=-1)  # (B, H, N, N)
        out = torch.einsum("bhij,bjhd->bihd", attn, v) + bc
        if fw.intrinsic:
            fdiff = torch.einsum("bhij,bjc->bhic", attn, xc) - xc[:, None]
            out = out + torch.einsum("bhic,chd->bihd", fdiff, kc)
        if fw.distances:
            attn_sq = (attn * sq[:, None, None, :]).sum(dim=-1)  # (B, H, N)
            attn_gram = (attn * gram[:, None]).sum(dim=-1)
            fdist = attn_sq + sq[:, None] - 2.0 * attn_gram
            out = out + torch.einsum("bhi,hd->bihd", fdist, kd)
        attn_out = out.reshape(bsz, n, heads * dh) @ d["wo"] + d["b_out"]

        gate = torch.sigmoid(attn_out @ d["ga1"] + h @ d["gh1"])[..., None]
        h = attn_out * gate + h * (1.0 - gate)

        hl2 = _layer_norm(h, d["ln2_g"], d["ln2_b"])
        ff = F.gelu(hl2 @ d["w1"] + d["b1"], approximate="none")
        ff = ff @ d["w2"] + d["b2"]
        gate = torch.sigmoid(ff @ d["ga2"] + h @ d["gh2"])[..., None]
        h = ff * gate + h * (1.0 - gate)
    energy = h @ fw.glob["wdec"] + fw.glob["bdec"]  # (B, N)
    return energy.sum()


def fused_force_reference(x: torch.Tensor, t, fw: Folded) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3) -> eps_hat (B, N, 3),
    ``-dE/dx_c`` of :func:`_energy` by autograd. Opens ``enable_grad``
    itself, so it also runs inside a ``no_grad`` step loop."""
    xc = x - x.mean(dim=1, keepdim=True)
    with torch.enable_grad():
        xc = xc.detach().requires_grad_(True)
        energy = _energy(xc, t, fw)
        if not energy.requires_grad:
            # Without edge features and absolute coordinates the energy does
            # not depend on x: the force is zero.
            return torch.zeros_like(x)
        (grad,) = torch.autograd.grad(energy, xc)
    return -grad


def _lib():
    lib = _build.load("fused_score")
    if not getattr(lib, "_argtypes_set", False):
        dims = [ctypes.c_int] * 9
        lib.fused_force_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_int] + dims + [ctypes.c_void_p]
        )
        lib.fused_force_launch.restype = ctypes.c_int
        lib.fused_force_weight_floats.argtypes = dims
        lib.fused_force_weight_floats.restype = ctypes.c_longlong
        lib.fused_force_error_string.argtypes = [ctypes.c_int]
        lib.fused_force_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _dims(fw: Folded):
    return (fw.n, fw.c, fw.heads, fw.dh, fw.ff, fw.n_layers,
            int(fw.intrinsic), int(fw.distances), int(fw.abs_coords))


def fused_force(x: torch.Tensor, t: float, fw: Folded) -> torch.Tensor:
    """Fused force evaluation: (B, N, 3) float32 -> eps_hat (B, N, 3).

    On a CPU tensor this runs :func:`fused_force_reference`. On a CUDA
    tensor it launches the kernel or raises; it never falls back. The
    number of kernel launches is counted in ``fused_force.launches``.

    The kernel runs a fixed grid of thread blocks that walk over tiles of
    several chains (:func:`twoforone_torch.ops.tile_plan.plan_tiles` picks
    the tile size from the chain count); each block has its own scratch for
    activations and residuals, so the scratch does not grow with the chain
    count. A chain's result does not depend on the batch it arrives in.
    """
    if x.device.type == "cpu":
        return fused_force_reference(x, t, fw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_force runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1:] != (fw.n, 3):
        raise ValueError(
            f"expected float32 (B, {fw.n}, 3), got {tuple(x.shape)} {x.dtype}"
        )
    if fw.flat.device != x.device:
        raise ValueError(f"weights on {fw.flat.device}, coordinates on {x.device}")
    if fw.n > MAX_N or fw.c % 4 or fw.dh % 4 or fw.ff % 4:
        raise ValueError(
            f"the fused force kernel takes at most {MAX_N} beads and hidden, head and "
            f"feed-forward widths that are multiples of 4; got N={fw.n}, C={fw.c}, "
            f"dh={fw.dh}, F={fw.ff}"
        )
    lib = _lib()
    dims = _dims(fw)
    if not fw.checked:
        if lib.fused_force_weight_floats(*dims) != fw.flat.numel():
            raise RuntimeError("folded weight buffer does not match the kernel's layout")
        fw.checked = True
    x = x.contiguous()
    bsz = x.shape[0]
    out = torch.empty_like(x)
    if bsz == 0:
        return out
    plan = plan_tiles(bsz, fw.n, fw.c, fw.heads, fw.dh, fw.ff, fw.n_layers,
                      sm_count(x.device.index), distances=fw.distances)
    scratch = torch.empty(plan.blocks * plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_force_launch(
        x.data_ptr(), out.data_ptr(), fw.flat.data_ptr(), scratch.data_ptr(), float(t), bsz,
        plan.chains_per_tile, plan.row_blocks, plan.blocks, plan.scratch_floats,
        plan.smem_bytes, *dims, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_force kernel launch failed: {lib.fused_force_error_string(rc).decode()}"
        )
    fused_force.launches += 1
    return out


fused_force.launches = 0


def make_fused_force_kernel(model, params, t_norm=None, device="cuda"):
    """Build the score-net force evaluation as one kernel launch per call
    (the JAX factory's name and meaning).

    ``model``: conservative GraphTransformer, any edge configuration. With a
    fixed ``t_norm`` the returned callable is ``x -> eps_hat`` (Langevin runs
    at one noise level); with ``t_norm=None`` it is ``(x, t) -> eps_hat``
    with ``t`` a host float (the reverse chain, where t varies per step).
    ``eps_hat = -dE/dx_c`` as ``score_forward`` gives it. x: (B, N, 3)
    float32 on ``device``, any B. ``block_chains``, ``packed``, ``remat``,
    ``vmem_limit_mb`` and ``precision`` of the JAX factory are TPU tiling
    and compiler arguments and have no counterpart. Runs on the card unless
    the caller asks for the CPU, where it is the plain version. The folded
    weights are exposed as ``.folded``.
    """
    folded = augment_params(model, params, device)
    if t_norm is None:
        def fn(x, t):
            return fused_force(x, float(t), folded)
    else:
        def fn(x):
            return fused_force(x, t_norm, folded)
    fn.folded = folded
    return fn
