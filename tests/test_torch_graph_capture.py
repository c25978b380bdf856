"""The capture helper of the port's CUDA graphs
(``twoforone_torch/utils/cuda_graph.py::StepGraphs``).

On the CPU a stand-in (:class:`StandInGraphs`) takes the place of the CUDA
calls and keeps the rest: its warm-up is a real call; its capture runs the
function's Python once more, as a real capture does, but on fake tensors
that carry shapes alone, so no real tensor is read or written, host state
the function changes changes once more, a read of a device value on the
host raises, and the wrappers count the launches they record; it keeps the
operations on a tape with the tensors and numbers they were given. Its
replay runs that tape (not the Python, not the function passed with the
call) on the tensors of the capture, writing into the outputs of the
capture, with the launch counters left as a real replay leaves them. The
loops' tests (``test_torch_graph_langevin.py``,
``test_torch_graph_sampler.py``, ``test_torch_graph_train.py``) drive
their graphed forms through it. The ``cuda`` tests need the card and skip
without one; this file imports nothing of JAX, so on a GPU machine
without it: ``python -m pytest tests/test_torch_graph_capture.py -m cuda
--noconftest``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

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


class _Recording(TorchDispatchMode):
    """A capture's recording on the CPU. Every operation runs on fake
    tensors: each real tensor an operation is given is replaced by its fake
    (shape, dtype and device, no data), so nothing real is read or written
    and a read of a value on the host raises. (A fake-tensor mode alone
    would run an operation whose inputs are all real on the real tensors.)
    Each operation is kept on a tape with the real tensors it was given and
    the numbers it was called with; :meth:`replay` runs the tape on those
    tensors, as a CUDA graph replays its kernels on the memory they used at
    the capture, whatever the Python would do now."""

    def __init__(self):
        super().__init__()
        self.fake = FakeTensorMode(allow_non_fake_inputs=True)
        self.tape, self.real, self.held = [], {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def fake(a):
            if isinstance(a, torch.Tensor) and not isinstance(a, FakeTensor):
                f = self.fake.from_tensor(a)
                self.real[id(f)] = a
                self.held.append(f)
                return f
            return a

        args, kwargs = tree_map(fake, (args, kwargs or {}))
        with self.fake:
            out = func(*args, **kwargs)
        self.tape.append((func, args, kwargs, out))
        self.held.append(out)  # the ids of the tape's tensors stay unique
        return out

    @torch.no_grad()
    def replay(self) -> dict:
        """Runs the tape; returns the real tensor of each fake by its id."""
        values = dict(self.real)

        def real(a):
            return values[id(a)] if isinstance(a, FakeTensor) else a

        for func, args, kwargs, out in self.tape:
            got = func(*tree_map(real, args), **tree_map(real, kwargs))
            for f, r in zip(tree_leaves(out), tree_leaves(got)):
                if isinstance(f, FakeTensor):
                    values[id(f)] = r
        return values


class _StandInGraph:
    def __init__(self, recording, recorded_outputs, outputs):
        self.recording, self.recorded_outputs, self.outputs = recording, recorded_outputs, outputs
        self.replays = 0

    def replay(self):
        values = self.recording.replay()  # runs no wrapper: the counters stay
        for static, fake in zip(cuda_graph._tensors(self.outputs),
                                cuda_graph._tensors(self.recorded_outputs)):
            static.copy_(values[id(fake)])
        self.replays += 1


class StandInGraphs(StepGraphs):
    """:class:`StepGraphs` on the CPU, with a stand-in for the CUDA graph."""

    def __init__(self, device="cpu"):
        super().__init__(device)
        self.warm_ups = self.captures = 0

    def _warm_up(self, fn):
        self._first = fn()
        self.warm_ups += 1
        return self._first

    def _capture(self, fn):
        # A capture runs fn's Python once more and records its work without
        # running it: here fn runs on fake tensors, so host state that fn
        # changes changes once more, as on the card, and a read of a value on
        # the host (a sync) raises. The wrappers count the launches they
        # record. The outputs of a capture are tensors of the warm-up's
        # shapes, which every replay rewrites.
        recording = _Recording()
        with recording:
            recorded = fn()
        self.captures += 1
        outputs = _clone(self._first)
        return _StandInGraph(recording, recorded, outputs), outputs


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
            fn()  # the recording counts what it records, then fails
            raise RuntimeError("operation not permitted when stream is capturing")

    graphs = Failing()
    with pytest.raises(RuntimeError, match="capturing"):
        graphs("k", _counting_fn(torch.ones(3), 1.0))
    assert kernel_launches() == PER_CALL  # the warm-up ran, the recording did not
    assert graphs.graphs == {}


def test_the_capture_reruns_the_python_and_writes_nothing():
    """As on the card: the recording runs the function's Python (a host
    counter it advances advances once more) and executes none of its work
    (the tensor it adds to is the warm-up's result, untouched)."""
    graphs = StandInGraphs()
    x, calls = torch.zeros(3), []

    def fn():
        calls.append(1)
        x.add_(1.0)

    graphs("k", fn)
    assert len(calls) == 2 and torch.equal(x, torch.ones(3)) and graphs.captures == 1
    graphs("k", fn)  # a replay runs the recorded work, not the Python
    assert len(calls) == 2 and torch.equal(x, torch.full((3,), 2.0))


def test_a_replay_uses_the_tensors_and_numbers_of_the_capture():
    """What a replay reads is fixed at the capture: a tensor rebound since
    is not seen (the captured one is), and a Python number is a constant."""
    graphs = StandInGraphs()
    state = {"x": torch.ones(3), "scale": 2.0}

    def fn():
        return state["x"] * state["scale"]

    graphs("k", fn)
    captured = state["x"]
    state["x"], state["scale"] = torch.full((3,), 10.0), 3.0
    captured += 1.0
    assert torch.equal(graphs("k", fn), torch.full((3,), 4.0))


def test_a_host_read_inside_the_capture_raises():
    """A capture cannot read a device value on the host; neither can the
    stand-in's."""
    graphs = StandInGraphs()
    x = torch.ones(3)
    with pytest.raises(Exception):
        graphs("k", lambda: x * float(x.sum()))
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


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "stand_in"])
def test_static_output_and_run_give_the_eager_loop_or_the_replay(graphed):
    """The seam every captured loop is written through. With no graphs:
    ``static`` gives the value itself, ``output`` a new zeroed tensor, and
    ``run`` calls the function. With graphs: both give the same buffer at
    every call, and ``run`` captures at the first call and replays after,
    on what the buffers then hold."""
    graphs = StandInGraphs() if graphed else None
    calls, given, seen, zeroed = [], [], [], []
    for k in range(3):
        value = torch.full((3,), float(k + 1))
        a = cuda_graph.static(graphs, "a", value)
        out = cuda_graph.output(graphs, "out", value)
        given.append(value)
        seen.append((a, out))
        zeroed.append(not out.any())

        def fn():
            calls.append(k)
            out.copy_(2.0 * a)
            return a + 1.0

        got = cuda_graph.run(graphs, "k", fn)
        assert torch.equal(out, 2.0 * value) and torch.equal(got, value + 1.0)
    if graphed:
        a0, out0 = graphs.buffer("a", (3,)), graphs.buffer("out", (3,))
        assert all(a is a0 and out is out0 for a, out in seen)
        assert calls == [0, 0] and graphs.graphs["k"][0].replays == 2
    else:
        assert all(a is v and out is not v for (a, out), v in zip(seen, given))
        assert all(zeroed) and len({id(out) for _, out in seen}) == 3
        assert calls == [0, 1, 2]


def test_only_the_seam_tells_eager_from_replayed():
    """No function of the package is a second, graphed form of a loop, and
    outside ``utils/cuda_graph.py`` a graphs object is compared with None
    only where ``Trainer._train_step`` chooses the staging ring."""
    import ast
    import pathlib

    root = pathlib.Path(cuda_graph.__file__).resolve().parents[1]
    graphed, compared = [], []

    def visit(node, path, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name
            if node.name.endswith("_graphed"):
                graphed.append(f"{path}::{node.name}")
        if isinstance(node, ast.Compare) and path != "utils/cuda_graph.py":
            operands = [node.left, *node.comparators]
            if (any(isinstance(o, ast.Constant) and o.value is None for o in operands)
                    and any(ast.unparse(o).endswith("graphs") for o in operands)):
                compared.append(f"{path}::{where}")
        for child in ast.iter_child_nodes(node):
            visit(child, path, where)

    for file in sorted(root.rglob("*.py")):
        path = file.relative_to(root).as_posix()
        visit(ast.parse(file.read_text()), path, None)
    assert graphed == []
    assert compared == ["train/trainer.py::_train_step"]


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
