"""The capture helper of the port's CUDA graphs
(``twoforone_torch/utils/cuda_graph.py::StepGraphs``).

On the CPU a stand-in (:class:`StandInGraphs`) takes the place of the CUDA
calls and keeps the rest: its warm-up is a real call, its capture records
the function without running it (the wrappers' counts of the recording are
added as a real recording adds them), and its replay runs the recorded
function, not the one passed with the call, writing into the outputs of the
capture, with the launch counters left as a real replay leaves them. The
loops' tests (``test_torch_graph_langevin.py``, ``test_torch_graph_sampler.py``)
drive their graphed forms through it. The ``cuda`` tests need the card and
skip without one; this file imports nothing of JAX, so on a GPU machine
without it: ``python -m pytest tests/test_torch_graph_capture.py -m cuda
--noconftest``.
"""

import pytest
import torch

from twoforone_torch.ops import attention_cl_core as acc
from twoforone_torch.ops import fused_score as fsc
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.utils import cuda_graph
from twoforone_torch.utils.cuda_graph import StepGraphs, kernel_launches, set_kernel_launches


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread while a module's tests run, as
    ``test_torch_checkpoint.py::one_torch_thread`` keeps it (that module
    imports flax; these import nothing of JAX): several pytest-xdist workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _StandInGraph:
    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs
        self.replays = 0

    def replay(self):
        counts = kernel_launches()  # a replay runs no wrapper
        fresh = self.fn()
        set_kernel_launches(counts)
        for static, new in zip(cuda_graph._tensors(self.outputs), cuda_graph._tensors(fresh)):
            static.copy_(new)
        self.replays += 1


class StandInGraphs(StepGraphs):
    """:class:`StepGraphs` on the CPU, with a stand-in for the CUDA graph."""

    def __init__(self, device="cpu"):
        super().__init__(device)
        self.warm_ups = 0

    def _warm_up(self, fn):
        before = kernel_launches()
        self._first = fn()
        self._recorded = tuple(a - b for a, b in zip(kernel_launches(), before))
        self.warm_ups += 1
        return self._first

    def _capture(self, fn):
        # Recording issues every launch of fn once and runs none of them; the
        # outputs of a capture are tensors of the warm-up's shapes.
        cuda_graph.add_kernel_launches(self._recorded)
        outputs = _clone(self._first)
        return _StandInGraph(fn, outputs), outputs


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(t) for t in tree)
    return tree


PER_CALL = (1, 3, 3, 2)  # K1, K2, K3, K4


def _counting_fn(x, scale):
    """A stand-in for a function whose wrappers launch kernels: it counts
    PER_CALL launches a call and returns a new tensor."""
    def fn():
        cuda_graph.add_kernel_launches(PER_CALL)
        return x * scale
    return fn


@pytest.fixture
def zero_launches():
    before = kernel_launches()
    set_kernel_launches((0, 0, 0, 0))
    yield
    set_kernel_launches(before)


def test_kernel_launches_reads_the_four_counters_in_order(zero_launches):
    fcl.fused_force_cl.launches = 1
    acc.cl_attention_core.launches_fwd = 2
    acc.cl_attention_core.launches_bwd = 3
    fsc.fused_force.launches = 4
    assert kernel_launches() == (1, 2, 3, 4)
    cuda_graph.add_kernel_launches((10, 20, 30, 40))
    assert (fcl.fused_force_cl.launches, acc.cl_attention_core.launches_fwd,
            acc.cl_attention_core.launches_bwd, fsc.fused_force.launches) == (11, 22, 33, 44)


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_launches_count_once_per_call_through_capture_and_replays(zero_launches, calls):
    """The warm-up counts as the call it is, the recording counts nothing,
    every replay adds what the recording recorded."""
    graphs = StandInGraphs()
    x = torch.arange(6.0)
    for _ in range(calls):
        graphs("k", _counting_fn(x, 2.0))
    assert kernel_launches() == tuple(calls * c for c in PER_CALL)
    assert graphs.warm_ups == 1 and graphs.graphs["k"][0].replays == calls - 1
    assert graphs.graphs["k"][2] == PER_CALL


def test_each_key_has_its_own_graph_and_counts(zero_launches):
    graphs = StandInGraphs()
    x = torch.arange(6.0)
    for key in ("a", "b", "a", "b", "a"):
        graphs(key, _counting_fn(x, 2.0))
    assert sorted(graphs.graphs) == ["a", "b"]
    assert kernel_launches() == tuple(5 * c for c in PER_CALL)


def test_replay_runs_the_captured_function_into_the_captures_outputs():
    """A replay ignores the function of its call, and returns the capture's
    outputs, rewritten."""
    graphs = StandInGraphs()
    x = torch.arange(4.0)
    first = graphs("k", _counting_fn(x, 2.0))
    out = graphs("k", _counting_fn(x, 100.0))
    assert torch.equal(first, 2.0 * x) and torch.equal(out, 2.0 * x)
    x += 1.0  # a static input changes: the next replay reads it
    again = graphs("k", _counting_fn(x, 100.0))
    assert again is out and torch.equal(out, 2.0 * x)


def test_a_failed_capture_raises_and_takes_its_counts_back(zero_launches):
    class Failing(StandInGraphs):
        def _capture(self, fn):
            cuda_graph.add_kernel_launches(self._recorded)
            raise RuntimeError("operation not permitted when stream is capturing")

    graphs = Failing()
    with pytest.raises(RuntimeError, match="capturing"):
        graphs("k", _counting_fn(torch.ones(3), 1.0))
    assert kernel_launches() == PER_CALL  # the warm-up ran, the recording did not
    assert graphs.graphs == {}


def test_buffers_are_static_by_name_shape_and_dtype():
    graphs = StandInGraphs()
    a = graphs.buffer("x", (2, 3))
    assert graphs.buffer("x", (2, 3)) is a and torch.equal(a, torch.zeros(2, 3))
    assert graphs.buffer("x", (3, 3)) is not a
    assert graphs.buffer("y", (2, 3)) is not a
    t = graphs.buffer("t", (), torch.long)
    assert t.dtype == torch.long and t.shape == () and graphs.buffer("t", (), torch.long) is t


def test_a_graph_keeps_its_function_alive():
    """The recorded kernels read what the function holds (weights, buffers),
    so the graph holds the function."""
    import gc
    import weakref

    graphs = StandInGraphs()
    held = torch.ones(3)
    fn = _counting_fn(held, 1.0)
    ref = weakref.ref(fn)
    graphs("k", fn)
    del fn
    gc.collect()
    assert ref() is not None


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_graph_replays_in_place_on_the_card(cuda_device, zero_launches):
    """A captured in-place update: the warm-up and every replay advance the
    static state exactly as eager calls do, launches counted once a call."""
    graphs = StepGraphs(cuda_device)
    x = graphs.buffer("x", (1000, 10, 3))
    x.copy_(torch.randn(1000, 10, 3, generator=torch.Generator(cuda_device).manual_seed(0),
                        device=cuda_device))
    ref = x.clone()
    noise = graphs.buffer("noise", x.shape)
    gen = torch.Generator(cuda_device).manual_seed(1)

    def step():
        cuda_graph.add_kernel_launches(PER_CALL)
        x.copy_(torch.tanh(x - x.mean(dim=-2, keepdim=True)) + 0.1 * noise)
        return x.sum()

    for k in range(5):
        z = torch.randn(x.shape, generator=gen, device=cuda_device)
        noise.copy_(z)
        out = graphs("step", step)
        ref = torch.tanh(ref - ref.mean(dim=-2, keepdim=True)) + 0.1 * z
        torch.cuda.synchronize()
        assert torch.equal(x, ref) and torch.equal(out, ref.sum())
    assert kernel_launches() == tuple(5 * c for c in PER_CALL)


@pytest.mark.cuda
def test_graphs_of_one_object_share_a_pool(cuda_device):
    graphs = StepGraphs(cuda_device)
    x = graphs.buffer("x", (256, 3))
    graphs("a", lambda: x * 2.0)
    pool = graphs._pool
    graphs("b", lambda: x + 1.0)
    assert pool is not None and graphs._pool is pool
    assert sorted(graphs.graphs) == ["a", "b"]
