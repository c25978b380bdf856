"""Molecular geometry ops (port of ``twoforone_tpu/ops/geometry.py``).

The SO(3) augmentation of training, and the geometry the evaluators read:
pairwise distances, dihedrals and Kabsch superposition / RMSD with mdtraj's
conventions, so that scores stay comparable with the golden references. Every function takes and
returns torch tensors; the evaluators hand them float32 coordinates, as the
JAX package computes them in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def center_zero(x: torch.Tensor) -> torch.Tensor:
    """Move each molecule's center of geometry to zero.

    ``x``: (..., N, 3); the mean is removed over the bead axis.
    """
    return x - x.mean(dim=-2, keepdim=True)


def assert_center_zero(x, eps: float = 1e-3) -> None:
    """Host-side check that each molecule's centre of geometry is at zero
    (tests and debug paths; the pipeline keeps the invariant by
    :func:`center_zero`). ``x``: (..., N, 3), a tensor or an array."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.ndim >= 2 and x.shape[-1] == 3, "Dimensionality error"
    center_max = float(np.abs(x.mean(axis=-2)).max())
    if center_max >= eps:
        raise AssertionError(f"Center not at zero: abs max at {center_max}")


def rotation_matrices(thetas: torch.Tensor) -> torch.Tensor:
    """Composed Euler rotations R = Rz @ Ry @ Rx from the angles ``thetas``
    (3, B) (rows: x, y, z) -> (B, 3, 3): the JAX package's matrices for the
    same angles."""
    c, s = torch.cos(thetas), torch.sin(thetas)
    zeros, ones = torch.zeros_like(c[0]), torch.ones_like(c[0])
    b = thetas.shape[1]
    rx = torch.stack([ones, zeros, zeros, zeros, c[0], s[0], zeros, -s[0], c[0]],
                     dim=-1).reshape(b, 3, 3)
    ry = torch.stack([c[1], zeros, -s[1], zeros, ones, zeros, s[1], zeros, c[1]],
                     dim=-1).reshape(b, 3, 3)
    rz = torch.stack([c[2], s[2], zeros, -s[2], c[2], zeros, zeros, zeros, ones],
                     dim=-1).reshape(b, 3, 3)
    # x -> Rx x, then Ry, then Rz (on column vectors).
    return torch.einsum("bij,bjk,bkl->bil", rz, ry, rx)


def random_rotation_matrices(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Per-sample rotations with each Euler angle ~ U(-pi, pi), drawn from
    ``generator`` on its device: (batch, 3, 3) float32."""
    u = torch.rand((3, batch), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return rotation_matrices(u * (2.0 * math.pi) - math.pi)


def rotate(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Apply ``rot`` (B, 3, 3) to each molecule of ``x`` (B, N, 3)."""
    return torch.einsum("bij,bnj->bni", rot, x)


def random_rotation(x: torch.Tensor, generator: torch.Generator,
                    return_matrices: bool = False):
    """Apply an independent random rotation to each molecule in the batch."""
    rot = random_rotation_matrices(generator, x.shape[0])
    out = rotate(x, rot)
    if return_matrices:
        return out, rot
    return out


def reverse_rotation(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Undo :func:`random_rotation` (rotations are orthogonal: inverse = transpose)."""
    return torch.einsum("bji,bnj->bni", rot, x)


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """Full (..., N, N) Euclidean pairwise-distance matrix."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return torch.linalg.norm(diff, dim=-1)


def triu_indices(n: int, offset: int) -> tuple[np.ndarray, np.ndarray]:
    return np.triu_indices(n, k=offset)


def pwd_triu_batch(x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """Upper-triangle pairwise distances for a batch: (B, N, 3) -> (B, n_pairs)."""
    assert x.ndim == 3 and x.shape[-1] == 3, "Shape mismatch"
    iu, ju = triu_indices(x.shape[1], offset)
    return pairwise_distances(x)[:, torch.from_numpy(iu), torch.from_numpy(ju)]


def dihedrals(xyz: torch.Tensor, indices) -> torch.Tensor:
    """Signed dihedral angles with mdtraj's sign convention
    (``mdtraj.compute_dihedrals``):

      b1 = p1-p0, b2 = p2-p1, b3 = p3-p2
      angle = atan2( (b1 x b2) . b3 * |b2|, (b2 x b3) . (b1 x b2) )

    ``xyz``: (B, N, 3); ``indices``: (M, 4) int -> (B, M) radians in [-pi, pi].
    """
    idx = torch.as_tensor(np.asarray(indices), dtype=torch.long)
    p = xyz[:, idx, :]  # (B, M, 4, 3)
    b1 = p[..., 1, :] - p[..., 0, :]
    b2 = p[..., 2, :] - p[..., 1, :]
    b3 = p[..., 3, :] - p[..., 2, :]
    c1 = torch.linalg.cross(b2, b3)
    c2 = torch.linalg.cross(b1, b2)
    p1 = torch.sum(b1 * c1, dim=-1) * torch.linalg.norm(b2, dim=-1)
    p2 = torch.sum(c1 * c2, dim=-1)
    return torch.atan2(p1, p2)


def sliding_dihedral_indices(num_beads: int) -> np.ndarray:
    """All consecutive 4-mers along the chain: the TICA feature dihedrals."""
    ind = np.arange(0, num_beads - 3)
    return np.stack((ind, ind + 1, ind + 2, ind + 3)).T


def unsorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                         normalization_factor, aggregation_method: str) -> torch.Tensor:
    """Segment sum over the leading axis of ``data``, divided by
    ``normalization_factor`` (``"sum"``) or by each segment's count, at least
    1 (``"mean"``). Kept for API parity: the dense-attention main path does
    not use it. Every id must lie in [0, num_segments)."""
    seg = data.new_zeros((num_segments, *data.shape[1:]))
    seg.index_add_(0, segment_ids, data)
    if aggregation_method == "sum":
        return seg / normalization_factor
    if aggregation_method == "mean":
        counts = data.new_zeros((num_segments, *data.shape[1:]))
        counts.index_add_(0, segment_ids, torch.ones_like(data))
        return seg / torch.clamp(counts, min=1.0)
    raise ValueError(f"unknown aggregation {aggregation_method}")


def _kabsch_rotation(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Optimal proper rotations (B, 3, 3) taking each centred frame of ``x``
    (B, N, 3) onto the centred reference ``r`` (N, 3), applied as ``x @ R``:
    R = u diag(1, 1, sign det(u vt)) vt from the SVD of the covariance. On a
    CUDA tensor the batched SVD runs on the card (cuSOLVER)."""
    cov = torch.einsum("bni,nj->bij", x, r)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, torch.sign(det)], dim=-1)
    return torch.einsum("bij,bj,bjk->bik", u, d, vt)


def superpose(xyz: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Optimally superpose each frame onto ``ref`` (Kabsch), like
    ``mdtraj.Trajectory.superpose``: (B, N, 3) -> (B, N, 3) aligned frames,
    centred at the reference's centroid."""
    x = center_zero(xyz)
    ref_mean = ref.mean(dim=0, keepdim=True)
    rot = _kabsch_rotation(x, ref - ref_mean)
    return torch.einsum("bni,bij->bnj", x, rot) + ref_mean[None]


def kabsch_rmsd(xyz: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Minimum RMSD of each frame (B, N, 3) to ``ref`` (N, 3) after optimal
    superposition -> (B,), the result ``mdtraj.rmsd`` gives.

    The rotation is applied and the distance measured, rather than taken from
    |x|^2 + |r|^2 - 2 tr(S), whose cancellation in float32 can leave a tiny
    negative under the square root for a frame equal to the reference.
    """
    x = center_zero(xyz)
    r = ref - ref.mean(dim=0, keepdim=True)
    x_aligned = torch.einsum("bni,bij->bnj", x, _kabsch_rotation(x, r))
    return torch.sqrt(torch.mean(torch.sum((x_aligned - r[None]) ** 2, dim=-1), dim=-1))
