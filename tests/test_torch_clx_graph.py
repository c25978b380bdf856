"""The clx force evaluation captured in a CUDA graph
(``ops/fused_score_clx.py::GraphedEvaluation``).

On the CPU the evaluation stays eager and makes no graph. The other tests
need the card (the kernels and CUDA graphs have no CPU mode) and skip
without one; they import nothing of JAX, so they also run on a GPU machine
without it: ``python -m pytest tests/test_torch_clx_graph.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.ops import attention_cl_core as tcore
from twoforone_torch.ops.fused_score_cl import fused_force_cl_reference
from twoforone_torch.ops.fused_score_clx import make_clx_force_fn

EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
N = 12


def _model():
    """N=12, hidden 16, three layers (three launches of each kernel an
    evaluation), seeded weights."""
    model = GraphTransformer(N, 16, 3, **EDGES)
    return model, init_params(model, 0)


def _coords(seed, chains, device="cpu"):
    x = np.random.default_rng(seed).normal(size=(chains, N, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("t_norm", [0.015, None])
def test_clx_on_cpu_is_eager_and_captures_nothing(monkeypatch, t_norm):
    """On the CPU the evaluation is the plain one, bit for bit, and no CUDA
    graph is made (making one fails the test)."""
    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    model, params = _model()
    x = _coords(0, 5)
    fn = make_clx_force_fn(model, params, t_norm, "cpu")
    assert fn.graphed is None
    out = fn(x) if t_norm is not None else fn(x, 0.37)
    ref = fused_force_cl_reference(x, 0.37 if t_norm is None else t_norm, fn.folded)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_clx_leaves_the_callers_tf32_setting(monkeypatch, caller_tf32):
    """An evaluation runs its products in float32 (TF32 off while it runs, and
    so while a graph is captured) and gives the caller's setting back."""
    seen = []
    real = tcore.cl_attention_reference

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)

    monkeypatch.setattr(tcore, "cl_attention_reference", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller_tf32)
    model, params = _model()
    make_clx_force_fn(model, params, 0.015, "cpu")(_coords(5, 2))
    assert seen == [False] * 3
    assert torch.backends.cuda.matmul.allow_tf32 is caller_tf32


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return _model()


def _close(got, ref):
    """1e-6 of the largest force: the same kernels in the same order give
    the same bits, unless cuBLAS picks another algorithm under capture."""
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * ref.abs().max().item())


@pytest.mark.cuda
def test_graphed_clx_follows_t_across_replays(cuda_model):
    """Calls at t = 0.2, 0.7, 0.2, 0.7 (the first captures, the rest replay;
    the last t a 0-d tensor): each equals the eager evaluation at its own t,
    so t is not baked into the graph."""
    model, params = cuda_model
    fn = make_clx_force_fn(model, params, None, "cuda")
    eager = make_clx_force_fn(model, params, None, "cuda", graphed=False)
    x = _coords(1, 300, "cuda")
    ts = (0.2, 0.7, 0.2, 0.7)
    outs = [fn(x, t) for t in (*ts[:3], torch.tensor(ts[3], device="cuda"))]
    assert list(fn.graphed.graphs) == [(300, N, 3)]
    for out, t in zip(outs, ts):
        _close(out, eager(x, t))
    assert (outs[0] - outs[1]).abs().max().item() > 1e-3 * outs[0].abs().max().item()


@pytest.mark.cuda
def test_graphed_clx_recaptures_for_a_new_shape(cuda_model):
    model, params = cuda_model
    fn = make_clx_force_fn(model, params, 0.015, "cuda")
    eager = make_clx_force_fn(model, params, 0.015, "cuda", graphed=False)
    for chains in (256, 300, 256, 300):
        x = _coords(chains, chains, "cuda")
        _close(fn(x), eager(x))
    assert sorted(fn.graphed.graphs) == [(256, N, 3), (300, N, 3)]


@pytest.mark.cuda
def test_graphed_clx_counts_launches_at_every_replay(cuda_model):
    """After k calls (the first captures) each kernel counts 3 k launches at
    three layers: one per evaluation that ran, none for the recording."""
    model, params = cuda_model
    fn = make_clx_force_fn(model, params, 0.015, "cuda")
    x = _coords(2, 256, "cuda")
    core = tcore.cl_attention_core
    core.launches_fwd = core.launches_bwd = 0
    for k in range(1, 5):
        fn(x)
        assert (core.launches_fwd, core.launches_bwd) == (3 * k, 3 * k)


@pytest.mark.cuda
def test_graphed_clx_result_survives_the_next_call(cuda_model):
    model, params = cuda_model
    fn = make_clx_force_fn(model, params, None, "cuda")
    x, y = _coords(3, 256, "cuda"), _coords(4, 256, "cuda")
    fn(x, 0.1)  # capture
    first = fn(x, 0.1)
    kept = first.clone()
    fn(y, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
