"""Fused conservative force evaluation: one CUDA kernel per force call.

Port of ``twoforone_tpu/ops/fused_score_cl.py::make_fused_force_kernel_cl``
(the chain-lane Pallas kernel). One call computes, for every chain,

    eps_hat = -dE/dx_c,   x_c = x - mean_beads(x),

where E is the summed per-node energy of the conservative
``GraphTransformer`` at normalized noise level ``t``: the whole energy
forward and its backward (input gradients only) run inside one launch of
``csrc/fused_score_cl.cu``. The gradient is taken with respect to the
*centred* coordinates, with no projection afterwards, as in the JAX kernel.
``t`` is a kernel argument, so the fixed-t form (Langevin) and the runtime-t
form (i.i.d. sampling) are the same kernel.

It covers the production edge configuration of every shipped model
(intrinsic-coordinate edges, no absolute coordinates, no distances).

Three pieces live here:

- :func:`augment_params_cl` folds the flax weights host-side into the
  kernel's layout;
- :func:`fused_force_cl_reference` is the plain PyTorch version, an eager
  transcription of the JAX kernel's ``_energy_forward_cl`` differentiated
  with autograd;
- :func:`fused_force_cl` is the kernel wrapper: a CPU tensor goes to the
  plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from twoforone_torch.ops import _build
from twoforone_torch.ops.attention_cl_core import cl_attention_reference
from twoforone_torch.ops.tile_plan import plan_tiles
from twoforone_torch.utils.device import resolve_device, sm_count

# Largest bead count at which the kernel has been held against its plain
# version on the card; the "auto" force path picks the kernel up to here.
VERIFIED_MAX_N = 10

# Largest bead count the kernel takes (csrc/fused_score_cl.cu, ``MAX_N``).
MAX_N = 64

# Per-layer weight order in the kernel's flat buffer (csrc/fused_score_cl.cu,
# ``layer_weights``). Matrices are (in, out) row-major; the ``*T`` copies are
# their (out, in) transposes, read by the backward's input-gradient products.
# ``wqkv`` is [wq | wk | wv] (C, 3 inner) with ``bqkv`` its bias, so that the
# three input projections are one product, and ``wqkvT`` its transpose (the
# three transposes stacked).
_LAYER_ORDER = (
    "ln1_g", "ln1_b", "wqkv", "bqkv", "kc", "wo", "bo",
    "ga1", "gh1", "ln2_g", "ln2_b", "w1", "b1", "w2", "b2", "ga2", "gh2",
    "wqkvT", "woT", "w1T", "w2T",
)
_GLOBAL_ORDER = ("h0", "wt", "wdec", "bdec")


@dataclass
class FoldedCL:
    """Folded weights of one model: the tensors the plain version reads and
    the flat buffer the kernel reads, on one device."""

    n: int
    c: int
    heads: int
    dh: int
    ff: int
    layers: list  # per-layer dicts of tensors
    glob: dict  # h0 (N, C), wt (C,), wdec (C,), bdec (1,)
    flat: torch.Tensor  # kernel layout, 1-D float32
    checked: bool = False  # the flat buffer's size was held against the library

    @property
    def inner(self) -> int:
        return self.heads * self.dh

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def augment_params_cl(model, params, device="cuda") -> FoldedCL:
    """Host-side weight folding (port of ``_augment_params_cl``).

    ``model`` describes the architecture (any object with ``num_beads``,
    ``hidden_nf``, ``n_layers``, ``heads``, ``dim_head`` and the edge flags,
    e.g. the port's ``GraphTransformer``); ``params`` is the flax parameter
    tree as nested dicts of numpy arrays.

    Folds, per layer:

    - the node embedding into ``h0 + t * wt`` (features are
      ``[one-hot, t]``, so the embedded nodes are a constant (N, C) map plus
      t times the time row);
    - the edge pipeline into ``kc = W_emb @ W_e`` (3, inner) and
      ``bc = b_emb @ W_e + b_e`` (inner,); its value-side bias survives the
      softmax as ``bo = bc @ W_out + b_out`` (``b_out_total``), and its
      per-head diff map folded through ``to_out`` is ``md`` (H, 3, C);
    - each gated residual's ``[x, res, x - res]`` projection into
      ``x·ga + res·gh`` with ``ga = w_x + w_d``, ``gh = w_res - w_d``.
    """
    if not (model.conservative and model.use_intrinsic_coords
            and not model.use_abs_coords and not model.use_distances):
        raise ValueError(
            "the fused chain-lane kernel covers the production edge config "
            "(conservative, intrinsic coords, no abs coords, no distances)"
        )
    p = params
    f32 = lambda a: np.asarray(a, np.float32)
    n, c = model.num_beads, model.hidden_nf
    heads, dh = model.heads, model.dim_head
    inner = heads * dh

    w_emb = f32(p["edge_embedding"]["kernel"])  # (3, De)
    b_emb = f32(p["edge_embedding"]["bias"])
    wn = f32(p["node_embedding"]["kernel"])  # (N+1, C)
    bn = f32(p["node_embedding"]["bias"])
    glob = {
        "h0": wn[:n] + bn[None, :],  # (N, C)
        "wt": wn[n],  # (C,)
        "wdec": f32(p["node_decoder"]["kernel"])[:, 0],
        "bdec": f32(p["node_decoder"]["bias"]).reshape(1),
    }

    def gate(proj):
        w = f32(proj["kernel"])[:, 0]  # (3C,) over [x, res, x - res]
        return w[:c] + w[2 * c:], w[c:2 * c] - w[2 * c:]

    layers = []
    for i in range(model.n_layers):
        attn = p[f"layers_{i}_attn"]
        w_e = f32(attn["edges_to_kv_kernel"])  # (De, inner)
        kc = w_emb @ w_e  # (3, inner)
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
            "kc": kc,
            "bc": bc,
            "md": np.stack([
                kc[:, h * dh:(h + 1) * dh] @ wo[h * dh:(h + 1) * dh] for h in range(heads)
            ]),  # (H, 3, C)
            "wo": wo,
            "bo": bc @ wo + f32(attn["to_out"]["bias"]),
            "ga1": ga1, "gh1": gh1,
            "ln2_g": f32(p[f"layers_{i}_ff_norm"]["scale"]),
            "ln2_b": f32(p[f"layers_{i}_ff_norm"]["bias"]),
            "w1": f32(ff["fc1"]["kernel"]), "b1": f32(ff["fc1"]["bias"]),
            "w2": f32(ff["fc2"]["kernel"]), "b2": f32(ff["fc2"]["bias"]),
            "ga2": ga2, "gh2": gh2,
        }
        d["wqkv"] = np.concatenate([d["wq"], d["wk"], d["wv"]], axis=1)
        d["bqkv"] = np.concatenate([d["bq"], d["bk"], d["bv"]])
        for name in ("wqkv", "wo", "w1", "w2"):
            d[name + "T"] = d[name].T
        layers.append(d)

    flat = np.concatenate(
        [np.ravel(d[k]) for d in layers for k in _LAYER_ORDER]
        + [np.ravel(glob[k]) for k in _GLOBAL_ORDER]
    ).astype(np.float32)
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    return FoldedCL(
        n=n, c=c, heads=heads, dh=dh, ff=layers[0]["w1"].shape[1],
        layers=[{k: to_t(v) for k, v in d.items() if not k.endswith("T") and "qkv" not in k}
                for d in layers],
        glob={k: to_t(v) for k, v in glob.items()},
        flat=to_t(flat),
    )


def _layer_norm(h, g, b, eps=1e-5):
    mean = h.mean(dim=-1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * g + b


def _energy_cl(xc, t, fw: FoldedCL, attention):
    """Summed energy of all chains; transcription of ``_energy_forward_cl``
    in the (B, N, feature) layout. xc: (B, N, 3) centred coordinates; ``t``
    a float or a 0-d tensor. ``attention`` computes the N^2 block,
    ``(q, k, v, xc, qb, qkd) -> (out, fdiff)``: the plain version for this
    module, the kernel pair on the attention-core path
    (``ops/fused_score_clx.py``)."""
    bsz, n, _ = xc.shape
    heads, dh = fw.heads, fw.dh
    t = t if torch.is_tensor(t) else float(t)
    h = fw.glob["h0"] + t * fw.glob["wt"]  # (N, C)
    h = h.expand(bsz, n, fw.c)
    for d in fw.layers:
        hl = _layer_norm(h, d["ln1_g"], d["ln1_b"])
        q = (hl @ d["wq"] + d["bq"]).view(bsz, n, heads, dh)
        k = (hl @ d["wk"] + d["bk"]).view(bsz, n, heads, dh)
        v = (hl @ d["wv"] + d["bv"]).view(bsz, n, heads, dh)
        qb = torch.einsum("bihd,hd->bhi", q, d["bc"].view(heads, dh))  # q . b_comb
        qkd = torch.einsum("bihd,chd->bhic", q, d["kc"].view(3, heads, dh))  # q . K_diff
        out_h, fdiff = attention(q, k, v, xc, qb, qkd)  # (B, N, H, dh), (B, H, N, 3)
        attn_out = (out_h.reshape(bsz, n, heads * dh) @ d["wo"]
                    + torch.einsum("bhic,hcd->bid", fdiff, d["md"]) + d["bo"])

        gate = torch.sigmoid(attn_out @ d["ga1"] + h @ d["gh1"])[..., None]
        h = attn_out * gate + h * (1.0 - gate)

        hl2 = _layer_norm(h, d["ln2_g"], d["ln2_b"])
        ff = F.gelu(hl2 @ d["w1"] + d["b1"], approximate="none")
        ff = ff @ d["w2"] + d["b2"]
        gate = torch.sigmoid(ff @ d["ga2"] + h @ d["gh2"])[..., None]
        h = ff * gate + h * (1.0 - gate)
    energy = h @ fw.glob["wdec"] + fw.glob["bdec"]  # (B, N)
    return energy.sum()


def eps_hat_cl(x: torch.Tensor, t, fw: FoldedCL, attention) -> torch.Tensor:
    """``-dE/dx_c`` of :func:`_energy_cl` by autograd: (B, N, 3) -> (B, N, 3),
    at any bead count. Opens ``enable_grad`` itself, so it also runs inside a
    ``no_grad`` step loop."""
    xc = x - x.mean(dim=1, keepdim=True)
    with torch.enable_grad():
        xc = xc.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(_energy_cl(xc, t, fw, attention), xc)
    return -grad


def fused_force_cl_reference(x: torch.Tensor, t, fw: FoldedCL) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3) -> eps_hat (B, N, 3)."""
    return eps_hat_cl(x, t, fw, cl_attention_reference)


def _lib():
    lib = _build.load("fused_score_cl")
    if not getattr(lib, "_argtypes_set", False):
        ints6 = [ctypes.c_int] * 6
        lib.fused_force_cl_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_int] + ints6 + [ctypes.c_void_p]
        )
        lib.fused_force_cl_launch.restype = ctypes.c_int
        lib.fused_force_cl_weight_floats.argtypes = ints6
        lib.fused_force_cl_weight_floats.restype = ctypes.c_longlong
        lib.cudaGetErrorString_port.argtypes = [ctypes.c_int]
        lib.cudaGetErrorString_port.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _dims(fw: FoldedCL):
    return (fw.n, fw.c, fw.heads, fw.dh, fw.ff, fw.n_layers)


def fused_force_cl(x: torch.Tensor, t: float, fw: FoldedCL) -> torch.Tensor:
    """Fused force evaluation: (B, N, 3) float32 -> eps_hat (B, N, 3).

    On a CPU tensor this runs :func:`fused_force_cl_reference`. On a CUDA
    tensor it launches the kernel or raises; it never falls back. The
    number of kernel launches is counted in ``fused_force_cl.launches``.

    The kernel runs a fixed grid of thread blocks that walk over tiles of
    several chains (:func:`twoforone_torch.ops.tile_plan.plan_tiles` picks
    the tile size from the chain count); each block has its own scratch for
    activations and residuals, so the scratch does not grow with the chain
    count. A chain's result does not depend on the batch it arrives in.
    """
    if x.device.type == "cpu":
        return fused_force_cl_reference(x, t, fw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_force_cl runs on CPU or CUDA tensors, got {x.device}")
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
    if not fw.checked:
        if lib.fused_force_cl_weight_floats(*_dims(fw)) != fw.flat.numel():
            raise RuntimeError("folded weight buffer does not match the kernel's layout")
        fw.checked = True
    x = x.contiguous()
    bsz = x.shape[0]
    out = torch.empty_like(x)
    if bsz == 0:
        return out
    plan = plan_tiles(bsz, *_dims(fw), sm_count(x.device.index))
    scratch = torch.empty(plan.blocks * plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_force_cl_launch(
        x.data_ptr(), out.data_ptr(), fw.flat.data_ptr(), scratch.data_ptr(), float(t), bsz,
        plan.chains_per_tile, plan.row_blocks, plan.blocks, plan.scratch_floats,
        plan.smem_bytes, *_dims(fw), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_force_cl kernel launch failed: {lib.cudaGetErrorString_port(rc).decode()}"
        )
    fused_force_cl.launches += 1
    return out


fused_force_cl.launches = 0
