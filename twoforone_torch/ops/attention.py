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
(B, N, H, dh), coordinates (B, N, 3). The network runs the packed form's
head-major core, :func:`geometric_attention_heads`, on (H, B, N, dh)
tensors.
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


class _Scores(torch.autograd.Function):
    """``q @ kᵀ`` per batch, whose backward returns k's gradient in k's own
    layout: autograd's ``bmm`` gives it transposed, which the head-major k,
    viewed from (H, B, N, dh), would then copy."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k.transpose(1, 2))

    @staticmethod
    def backward(ctx, grad):
        q, k = ctx.saved_tensors
        return torch.bmm(grad, k), torch.bmm(grad.transpose(1, 2), q)


class _AttnValues(torch.autograd.Function):
    """``attn @ v`` per batch, whose backward takes ``grad @ vᵀ`` through
    :class:`_Scores`, so that a second derivative also returns v's gradient
    in v's own layout."""

    @staticmethod
    def forward(ctx, attn, v):
        ctx.save_for_backward(attn, v)
        return torch.bmm(attn, v)

    @staticmethod
    def backward(ctx, grad):
        attn, v = ctx.saved_tensors
        return _Scores.apply(grad, v), torch.bmm(attn.transpose(1, 2), grad)


def geometric_attention_heads(q, k, v, x_heads, sq_heads, k_dist):
    """Head-major core of the geometric edge attention (the production
    form): batched products over the H·B head-chain pairs, no
    concatenation.

    The edge keys and values are ``(x_j − x_i) K_diff + dist_ij k_dist +
    b_comb``. Row-constant score terms (``q·b_comb``, ``−(q·K_diff)·x_i``,
    ``(q·k_dist)·sq_i``) cancel in the softmax, and each row of the attention
    sums to 1, so the caller puts the diff channel's per-j part into the
    keys and values (``k_j + x_j K_diff``, ``v_j + x_j K_diff``) and adds the
    per-row rest (``b_comb − x_i K_diff``) to the output. The distance
    channel stays here, as rank-3 products of its own after ``q·kᵀ``:

        sim_ij = q_i·k_j + (q_i·k_dist)(sq_j − 2 x_i·x_j)
        out_i  = Σ_j attn_ij v_j

    Args:
      q, k, v:  (H, B, N, dh) contiguous, heads first; q carries the softmax
                scale, k and v the diff channel.
      x_heads:  (H, B, N, 3) the coordinates repeated per head, read with
                ``k_dist``.
      sq_heads: (H, B, N, 1) their squared norms, read with ``k_dist``.
      k_dist:   (H, dh) combined dist kernel, or None.
    Returns ``(o, f_dist)`` as (H, B, N, ·): ``o_i = Σ_j attn_ij v_j`` and,
    with ``k_dist``, ``f_dist_i = Σ_j attn_ij dist_ij`` (the distance
    channel of the output is ``f_dist·k_dist``), else None.
    """
    h, b, n, dh = q.shape
    g = h * b
    sim = _Scores.apply(q.view(g, n, dh), k.view(g, n, dh))
    if k_dist is not None:
        x = x_heads.view(g, n, 3)
        sq = sq_heads.view(g, n, 1)
        q_ks = torch.bmm(q.view(h, b * n, dh), k_dist.unsqueeze(-1)).view(g, n, 1)
        sim.baddbmm_(-2.0 * q_ks * x, x.transpose(1, 2))
        sim.baddbmm_(q_ks, sq.transpose(1, 2))
    attn = torch.softmax(sim, dim=-1)
    o = _AttnValues.apply(attn, v.view(g, n, dh)).view(h, b, n, dh)
    if k_dist is None:
        return o, None
    xbar = torch.bmm(attn, x)
    f_dist = torch.bmm(attn, sq) + sq - 2.0 * torch.sum(x * xbar, dim=-1, keepdim=True)
    return o, f_dist.view(h, b, n, 1)


def geometric_edge_attention_packed(q, k, v, x, k_diff, k_dist, b_comb, scale):
    """Geometric edge attention in the JAX package's layout, computed by
    :func:`geometric_attention_heads` (the production form).

    Args/returns: as :func:`geometric_edge_attention`.
    """
    b_, n, h, dh = q.shape
    q, k, v = (t.permute(2, 0, 1, 3) for t in (q, k, v))
    x_heads = x.to(q.dtype).expand(h, b_, n, 3)
    out = b_comb.view(h, 1, 1, dh)  # rows of attn sum to 1
    if k_diff is not None:
        x_k = torch.einsum("hbjc,chd->hbjd", x_heads, k_diff)
        k, v, out = k + x_k, v + x_k, out - x_k
    o, f_dist = geometric_attention_heads(
        (q * scale).contiguous(), k.contiguous(), v.contiguous(), x_heads.contiguous(),
        torch.sum(x_heads * x_heads, dim=-1, keepdim=True), k_dist,
    )
    out = out + o
    if f_dist is not None:
        out = out + f_dist * k_dist.view(h, 1, 1, dh)
    return out.permute(1, 2, 0, 3)


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
