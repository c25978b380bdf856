"""Geometric edge-biased attention core: the N^2 block as a CUDA kernel pair.

Port of ``twoforone_tpu/ops/attention_cl_core.py::make_cl_attention_core``
(the Pallas forward ``_fwd_kernel`` and the hand-written VJP ``_bwd_kernel``).
Per chain b and head h, with ``scale = dh**-0.5``:

    sim[i, j]   = q_i . k_j + qb_i + qkd_i . (x_j - x_i)
    attn[i, :]  = softmax_j(scale * sim[i, :])
    out[i, :]   = sum_j attn[i, j] v_j
    fdiff[i, :] = sum_j attn[i, j] x_j - x_i

which is the factored geometric attention of ``ops/attention.py`` with the
q-side projections (``qb = q . b_comb``, ``qkd = q . K_diff``) precomputed by
the caller as plain matrix products.

Layout. The JAX kernel puts chains on the TPU's 128-lane minor axis,
``(H, dh, N, B)``, and pads B to 128. The port uses the layout its energy
function already has, row-major float32 with any B and no padding:

    q, k, v, out   (B, N, H, dh)
    x              (B, N, 3)
    qb             (B, H, N)
    qkd, fdiff     (B, H, N, 3)

What lives here: :func:`cl_attention_reference` and
:func:`cl_attention_bwd_reference` are the plain PyTorch versions of the two
kernels; :func:`cl_attention_fwd` and :func:`cl_attention_bwd` each launch
one kernel of ``csrc/attention_cl_core.cu``; :class:`ClAttentionCore` is the
``autograd.Function`` over the two; and :func:`cl_attention_core` is the
wrapper the energy calls: CPU tensors go to the plain version (autograd
differentiates it), CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from twoforone_torch.ops import _build

# What csrc/attention_cl_core.cu takes: one lane per key bead, and a shared
# memory budget that holds a (chain, head) tile of the backward.
KERNEL_MAX_N = 32
KERNEL_MAX_DH = 64


def cl_attention_reference(q, k, v, x, qb, qkd):
    """Plain PyTorch version of the forward kernel: ``(out, fdiff)``."""
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bihd,bjhd->bhij", q, k)
    sim = sim + qb[..., None]
    sim = sim + torch.einsum("bhic,bjc->bhij", qkd, x)
    sim = sim - torch.einsum("bhic,bic->bhi", qkd, x)[..., None]
    attn = torch.softmax(scale * sim, dim=-1)  # over j
    out = torch.einsum("bhij,bjhd->bihd", attn, v)
    fdiff = torch.einsum("bhij,bjc->bhic", attn, x) - x[:, None]
    return out, fdiff


def cl_attention_bwd_reference(q, k, v, x, qb, qkd, dout, dfd):
    """Plain PyTorch version of the backward kernel, by autograd through
    :func:`cl_attention_reference`: ``(dq, dk, dv, dx, dqb, dqkd)`` with dx
    already summed over heads."""
    with torch.enable_grad():
        ins = [a.detach().requires_grad_(True) for a in (q, k, v, x, qb, qkd)]
        out, fdiff = cl_attention_reference(*ins)
        dq, dk, dv, dx, dqb, dqkd = torch.autograd.grad((out, fdiff), ins, (dout, dfd))
    return dq, dk, dv, dx, dqb, dqkd


def _lib():
    lib = _build.load("attention_cl_core")
    if not getattr(lib, "_argtypes_set", False):
        dims = [ctypes.c_int] * 4 + [ctypes.c_void_p]  # batch, n, heads, dh, stream
        lib.cl_attention_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + dims
        lib.cl_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 14 + dims
        lib.cl_attention_fwd_launch.restype = ctypes.c_int
        lib.cl_attention_bwd_launch.restype = ctypes.c_int
        lib.cudaGetErrorString_port.argtypes = [ctypes.c_int]
        lib.cudaGetErrorString_port.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(name, tensors, shape):
    """Launch kernel ``name`` on the current stream; ``shape`` is q's
    (B, N, H, dh). Raises if the launch is refused."""
    for a in tensors:
        if not (a.is_cuda and a.dtype == torch.float32 and a.is_contiguous()):
            raise ValueError(f"{name} takes contiguous float32 CUDA tensors")
    lib = _lib()
    bsz, n, heads, dh = shape
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(lib, name)(*(a.data_ptr() for a in tensors), bsz, n, heads, dh, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.cudaGetErrorString_port(rc).decode()}")


def cl_attention_fwd(q, k, v, x, qb, qkd):
    """Launch the forward kernel on contiguous float32 CUDA tensors:
    ``(out, fdiff)``."""
    out = torch.empty_like(q)
    fdiff = torch.empty_like(qkd)
    _launch("cl_attention_fwd_launch", (q, k, v, x, qb, qkd, out, fdiff), q.shape)
    cl_attention_core.launches_fwd += 1
    return out, fdiff


def cl_attention_bwd(q, k, v, x, qb, qkd, dout, dfd):
    """Launch the backward kernel (it recomputes attn from the inputs) on
    contiguous float32 CUDA tensors: ``(dq, dk, dv, dx, dqb, dqkd)``. The
    kernel writes one dx share per head, with no atomics; they are summed
    over heads here."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dqb, dqkd, dxh = torch.empty_like(qb), torch.empty_like(qkd), torch.empty_like(qkd)
    _launch("cl_attention_bwd_launch",
            (q, k, v, x, qb, qkd, dout, dfd, dq, dk, dv, dqb, dqkd, dxh), q.shape)
    cl_attention_core.launches_bwd += 1
    return dq, dk, dv, dxh.sum(dim=1), dqb, dqkd


class ClAttentionCore(torch.autograd.Function):
    """``(q, k, v, x, qb, qkd) -> (out, fdiff)`` on CUDA tensors: the forward
    launches the forward kernel and saves the six inputs, the backward
    launches the backward kernel.

    First-order only: the force path differentiates the energy once, without
    ``create_graph``. Double backward (force matching in training) is not
    implemented; differentiating through the backward raises.
    """

    @staticmethod
    def forward(ctx, q, k, v, x, qb, qkd):
        ctx.save_for_backward(q, k, v, x, qb, qkd)
        return cl_attention_fwd(q, k, v, x, qb, qkd)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dfd):
        q, _, _, _, _, qkd = ctx.saved_tensors
        dout = torch.zeros_like(q) if dout is None else dout.contiguous()
        dfd = torch.zeros_like(qkd) if dfd is None else dfd.contiguous()
        return cl_attention_bwd(*ctx.saved_tensors, dout, dfd)


def _check(q, k, v, x, qb, qkd):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, dh), got {tuple(q.shape)}")
    bsz, n, heads, _ = q.shape
    want = {"q": q.shape, "k": q.shape, "v": q.shape, "x": (bsz, n, 3),
            "qb": (bsz, heads, n), "qkd": (bsz, heads, n, 3)}
    for name, a in zip(want, (q, k, v, x, qb, qkd)):
        if tuple(a.shape) != tuple(want[name]):
            raise ValueError(f"{name} must be {tuple(want[name])}, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")


def cl_attention_core(q, k, v, x, qb, qkd):
    """The attention core, differentiable once: ``(out, fdiff)``.

    On CPU tensors this runs :func:`cl_attention_reference`. On CUDA tensors
    it goes through :class:`ClAttentionCore` or raises; it never falls back.
    Kernel launches are counted in ``cl_attention_core.launches_fwd`` and
    ``cl_attention_core.launches_bwd``.
    """
    _check(q, k, v, x, qb, qkd)
    if q.device.type == "cpu":
        return cl_attention_reference(q, k, v, x, qb, qkd)
    if q.device.type != "cuda":
        raise ValueError(f"cl_attention_core runs on CPU or CUDA tensors, got {q.device}")
    n, dh = q.shape[1], q.shape[3]
    if not (1 <= n <= KERNEL_MAX_N and 1 <= dh <= KERNEL_MAX_DH):
        raise ValueError(
            f"the kernel takes N <= {KERNEL_MAX_N} and dh <= {KERNEL_MAX_DH}, got N={n}, dh={dh}"
        )
    return ClAttentionCore.apply(*(a.contiguous() for a in (q, k, v, x, qb, qkd)))


cl_attention_core.launches_fwd = 0
cl_attention_core.launches_bwd = 0
