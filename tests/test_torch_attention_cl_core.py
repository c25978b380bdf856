"""Port's attention core against the JAX package's Pallas core (interpret
mode) and its jnp oracle; the wrapper's CPU/CUDA routing and input checks.
The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against the plain versions).

The JAX core keeps chains on the minor axis, ``(H, dh, N, B)``; the port uses
``(B, N, H, dh)``. The tests draw inputs in the port's layout and permute
axes for the JAX side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.ops import attention_cl_core as jcore
from twoforone_torch.ops import attention_cl_core as tcore

H, DH, N, B = 3, 8, 20, 128
GRADS = ("dq", "dk", "dv", "dx", "dqb", "dqkd")

# port layout -> JAX layout, per argument; the inverse permutes results back
TO_JAX = {"q": (2, 3, 1, 0), "x": (2, 1, 0), "qb": (1, 2, 0), "qkd": (1, 3, 2, 0)}
FROM_JAX = {"q": (3, 2, 0, 1), "x": (2, 1, 0), "qb": (2, 0, 1), "qkd": (3, 0, 2, 1)}
KINDS = ("q", "q", "q", "x", "qb", "qkd")


def _inputs(b=B, n=N, h=H, dh=DH, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(b, n, h, dh), f(b, n, h, dh), f(b, n, h, dh), f(b, n, 3),
            f(b, h, n), 0.3 * f(b, h, n, 3))


def _to_jax(arrays, kinds=KINDS):
    return [jnp.asarray(a.transpose(TO_JAX[kd])) for a, kd in zip(arrays, kinds)]


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Forward of the interpret-mode Pallas core and of the jnp oracle, and
    the VJP of the Pallas core, all brought back to the port's layout."""
    ins = _inputs()
    rng = np.random.default_rng(1)
    dout = rng.normal(size=ins[0].shape).astype(np.float32)
    dfd = rng.normal(size=ins[5].shape).astype(np.float32)
    jins = _to_jax(ins)
    core = jcore.make_cl_attention_core(H, DH, N, interpret=True)
    (out, fd), vjp = jax.vjp(core, *jins)
    grads = vjp(tuple(_to_jax((dout, dfd), ("q", "qkd"))))
    oracle = jcore.cl_attention_reference(*jins)
    back = lambda a, kd: np.asarray(a).transpose(FROM_JAX[kd])
    return dict(
        ins=ins, dout=dout, dfd=dfd,
        pallas=(back(out, "q"), back(fd, "qkd")),
        oracle=(back(oracle[0], "q"), back(oracle[1], "qkd")),
        grads={name: back(g, kd) for name, g, kd in zip(GRADS, grads, KINDS)},
    )


@pytest.mark.parametrize("side", ["pallas", "oracle"])
def test_reference_matches_jax_forward(side):
    """atol 1e-5: O(1) outputs, f32 sums over dh = 8 and N = 20 in another
    order."""
    r = _jax_results()
    out, fd = tcore.cl_attention_reference(*map(torch.from_numpy, r["ins"]))
    np.testing.assert_allclose(out.numpy(), r[side][0], atol=1e-5)
    np.testing.assert_allclose(fd.numpy(), r[side][1], atol=1e-5)


@pytest.mark.parametrize("name", GRADS)
def test_bwd_reference_matches_jax_vjp(name):
    """All six gradients against ``jax.vjp`` of the interpret-mode core with
    the same cotangents (dx summed over heads on both sides). atol 1e-5
    scaled by the gradient's largest entry (dk, dv and dx sum over 20 rows
    and, for dx, 3 heads)."""
    r = _jax_results()
    T = torch.from_numpy
    grads = tcore.cl_attention_bwd_reference(*map(T, r["ins"]), T(r["dout"]), T(r["dfd"]))
    got = dict(zip(GRADS, grads))[name].numpy()
    ref = r["grads"][name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_wrapper_cpu_runs_plain_version_uncounted():
    ins = [torch.from_numpy(a) for a in _inputs(b=3, n=11)]  # any B, no padding
    ins[3].requires_grad_(True)
    before = (tcore.cl_attention_core.launches_fwd, tcore.cl_attention_core.launches_bwd)
    out, fd = tcore.cl_attention_core(*ins)
    (dx,) = torch.autograd.grad(out.sum() + fd.sum(), ins[3])
    assert (tcore.cl_attention_core.launches_fwd,
            tcore.cl_attention_core.launches_bwd) == before
    ref_out, ref_fd = tcore.cl_attention_reference(*ins)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(fd, ref_fd, rtol=0, atol=0)
    ref = tcore.cl_attention_bwd_reference(*ins, torch.ones_like(out), torch.ones_like(fd))
    torch.testing.assert_close(dx, ref[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", ["dtype", "q_rank", "k_shape", "x_shape", "qb_shape",
                                   "qkd_shape"])
def test_wrapper_rejects_bad_inputs(fault):
    q, k, v, x, qb, qkd = (torch.from_numpy(a) for a in _inputs(b=2, n=11))
    bad = {
        "dtype": (q, k, v.double(), x, qb, qkd),
        "q_rank": (q[0], k, v, x, qb, qkd),
        "k_shape": (q, k[:, :5], v, x, qb, qkd),
        "x_shape": (q, k, v, x[:, :, :2], qb, qkd),
        "qb_shape": (q, k, v, x, qb.transpose(1, 2), qkd),
        "qkd_shape": (q, k, v, x, qb, qkd[..., :2]),
    }[fault]
    with pytest.raises(ValueError):
        tcore.cl_attention_core(*bad)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Both kernels against their plain versions on the card at trp-cage
    width and a ragged chain count. 1e-4 of each output's largest entry: f32
    sums in another order (dqb, which cancels to zero, against dqkd's scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ins = [torch.from_numpy(a).cuda() for a in _inputs(b=37, n=20, h=8, dh=64, seed=4)]
    rng = np.random.default_rng(5)
    dout = torch.from_numpy(rng.normal(size=ins[0].shape).astype(np.float32)).cuda()
    dfd = torch.from_numpy(rng.normal(size=ins[5].shape).astype(np.float32)).cuda()
    leaves = [a.clone().requires_grad_(True) for a in ins]
    out, fd = tcore.cl_attention_core(*leaves)
    grads = torch.autograd.grad((out, fd), leaves, (dout, dfd))
    ref_out, ref_fd = tcore.cl_attention_reference(*ins)
    ref_grads = tcore.cl_attention_bwd_reference(*ins, dout, dfd)
    torch.cuda.synchronize()
    names = ("out", "fdiff", *GRADS)
    scales = {nm: ref.abs().max().item()
              for nm, ref in zip(names, (ref_out, ref_fd, *ref_grads))}
    scales["dqb"] = scales["dqkd"]  # dqb is zero in exact arithmetic (softmax rows sum to 1)
    for nm, got, ref in zip(names, (out, fd, *grads), (ref_out, ref_fd, *ref_grads)):
        assert (got - ref).abs().max().item() <= 1e-4 * scales[nm], nm
