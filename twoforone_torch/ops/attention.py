"""Edge-biased dense attention over beads (port of ``ops/attention.py``).

Per head, edge embeddings are projected and added to BOTH keys and values
before a dense softmax over all beads:

    sim[i, j] = scale * q_i . (k_j + W_e e_ij + b_e)
    out[i]    = sum_j attn[i, j] * (v_j + W_e e_ij + b_e)

``edge_biased_attention`` takes the explicit (B, N, N, De) edge tensor; the
two geometric forms fold the (linear) edge pipeline onto the raw coordinate
channels so that no N^2 feature tensor exists. All three compute the same
function up to rounding; ``edge_biased_attention_naive`` is the direct
form, kept as the tests' oracle. Layouts match the JAX package: q, k, v are
(B, N, H, dh), coordinates (B, N, 3).
"""

from __future__ import annotations

import torch


def edge_biased_attention(q, k, v, edges, w_e, b_e, scale):
    """Factored edge-biased attention.

    Args:
      q, k, v: (B, N, H, dh)
      edges:   (B, N, N, De), indexed [b, i, j].
      w_e:     (De, H, dh) edge projection kernel.
      b_e:     (H, dh) edge projection bias.
      scale:   softmax temperature, ``dh ** -0.5``.
    Returns: (B, N, H, dh)
    """
    sim = torch.einsum("bihd,bjhd->bhij", q, k)
    q_we = torch.einsum("bihd,ehd->bhie", q, w_e)
    sim = sim + torch.einsum("bhie,bije->bhij", q_we, edges)
    sim = sim + torch.einsum("bihd,hd->bhi", q, b_e)[..., None]
    attn = torch.softmax(scale * sim, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, v)
    attn_e = torch.einsum("bhij,bije->bhie", attn, edges)
    out = out + torch.einsum("bhie,ehd->bihd", attn_e, w_e)
    return out + b_e[None, None]  # rows of attn sum to 1


def edge_biased_attention_naive(q, k, v, edges, w_e, b_e, scale):
    """Direct transcription of the attention math, with the per-head edge
    tensor (B, N, N, H, dh) materialized (test oracle). Arguments as
    :func:`edge_biased_attention`."""
    ekv = torch.einsum("bije,ehd->bijhd", edges, w_e) + b_e[None, None, None]
    k_full = k[:, None, :, :, :] + ekv  # (B, i, j, H, dh) with k broadcast over i
    v_full = v[:, None, :, :, :] + ekv
    sim = torch.einsum("bihd,bijhd->bhij", q, k_full) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bhij,bijhd->bihd", attn, v_full)


def geometric_edge_attention_packed(q, k, v, x, k_diff, k_dist, b_comb, scale):
    """Geometric edge attention with the edge terms packed into one Q·K^T
    and one attn·V contraction per side (the production form).

    Row-constant score terms (``q·b_comb``, ``-(q·K_diff)·x_i``,
    ``(q·k_dist)·sq_i``) cancel in the softmax and are dropped; the
    surviving terms are linear in per-j features and ride as extra channels:

        q̃_i = [scale·q_i,  xcoef_i,  q·k_dist]
        k̃_j = [k_j,        x_j,      sq_j    ]
        xcoef_i = scale·(q_i K_diff − 2 (q_i·k_dist) x_i)

    Args/returns: as :func:`geometric_edge_attention`.
    """
    b_, n, h, dh = q.shape
    has_diff = k_diff is not None
    has_dist = k_dist is not None
    qs = q * scale
    parts_q, parts_k, parts_v = [qs], [k], [v]
    if has_diff or has_dist:
        xh = x[:, :, None, :].expand(b_, n, h, 3).to(q.dtype)
        parts_k.append(xh)
        parts_v.append(xh)
        xcoef = None
        if has_diff:
            xcoef = torch.einsum("bihd,chd->bihc", qs, k_diff)
        if has_dist:
            q_ks = torch.einsum("bihd,hd->bih", qs, k_dist)
            gram_coef = -2.0 * q_ks[..., None] * x[:, :, None, :].to(q.dtype)
            xcoef = gram_coef if xcoef is None else xcoef + gram_coef
        parts_q.append(xcoef)
    if has_dist:
        sq = torch.sum(x * x, dim=-1).to(q.dtype)  # (B, N)
        sqh = sq[:, :, None, None].expand(b_, n, h, 1)
        parts_k.append(sqh)
        parts_v.append(sqh)
        parts_q.append(q_ks[..., None])
    qt = torch.cat(parts_q, dim=-1)
    kt = torch.cat(parts_k, dim=-1)
    vt = torch.cat(parts_v, dim=-1)

    attn = torch.softmax(torch.einsum("bihe,bjhe->bhij", qt, kt), dim=-1)
    ot = torch.einsum("bhij,bjhe->bihe", attn, vt)

    out = ot[..., :dh] + b_comb[None, None]  # rows of attn sum to 1
    idx = dh
    if has_diff or has_dist:
        xbar = ot[..., idx : idx + 3]
        idx += 3
    if has_diff:
        out = out + torch.einsum(
            "bihc,chd->bihd", xbar - x[:, :, None, :].to(q.dtype), k_diff
        )
    if has_dist:
        sqbar = ot[..., idx]
        fdist = (
            sqbar
            + sq[:, :, None]
            - 2.0 * torch.sum(x[:, :, None, :].to(q.dtype) * xbar, dim=-1)
        )
        out = out + fdist[..., None] * k_dist[None, None]
    return out


def geometric_edge_attention(q, k, v, x, k_diff, k_dist, b_comb, scale):
    """Edge-biased attention with the N^2 edge tensors eliminated.

    The per-head edge keys/values are affine in the raw channels,

        ek[b,i,j] = diff[b,i,j] @ K_diff + dist[b,i,j] * k_dist + b_comb

    with ``diff[b,i,j] = x_j - x_i`` and squared distances ``dist``, so both
    attention contractions decompose exactly.

    Args:
      q, k, v: (B, N, H, dh)
      x:       (B, N, 3) centered coordinates
      k_diff:  (3, H, dh) combined diff kernel, or None
      k_dist:  (H, dh) combined dist kernel, or None
      b_comb:  (H, dh) combined bias
      scale:   dh ** -0.5
    Returns: (B, N, H, dh)
    """
    sim = torch.einsum("bihd,bjhd->bhij", q, k)
    sim = sim + torch.einsum("bihd,hd->bhi", q, b_comb)[..., None]

    if k_diff is not None:
        q_kd = torch.einsum("bihd,chd->bhic", q, k_diff)  # (B, H, N, 3)
        sim = sim + torch.einsum("bhic,bjc->bhij", q_kd, x)
        sim = sim - torch.einsum("bhic,bic->bhi", q_kd, x)[..., None]
    if k_dist is not None:
        sq = torch.sum(x * x, dim=-1)  # (B, N)
        gram = torch.einsum("bic,bjc->bij", x, x)  # (B, N, N)
        q_ks = torch.einsum("bihd,hd->bhi", q, k_dist)  # (B, H, N)
        dist = (sq[:, :, None] + sq[:, None, :] - 2.0 * gram)[:, None]
        sim = sim + q_ks[..., None] * dist

    attn = torch.softmax(scale * sim, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, v)
    out = out + b_comb[None, None]  # rows of attn sum to 1

    if k_diff is not None:
        xbar = torch.einsum("bhij,bjc->bhic", attn, x)
        fdiff = xbar - x[:, None, :, :]
        out = out + torch.einsum("bhic,chd->bihd", fdiff, k_diff)
    if k_dist is not None:
        attn_sq = torch.einsum("bhij,bj->bhi", attn, sq)
        attn_gram = torch.einsum("bhij,bij->bhi", attn, gram)
        fdist = attn_sq + sq[:, None, :] - 2.0 * attn_gram  # (B, H, N)
        out = out + torch.einsum("bhi,hd->bihd", fdist, k_dist)
    return out
