"""CUDA graphs for the port's compiled loops.

The JAX package compiles its hot loops into XLA programs: a save period of
Langevin steps (``lax.fori_loop`` in ``lax.scan``), each reverse chain
(``lax.scan`` under ``jax.jit``), the clx force evaluation and the training
step, chunk and loss evaluation. On the card the port records the same work
once in a CUDA graph and replays it, so the host issues one launch where an
eager step issues hundreds. :class:`StepGraphs` is the one capture helper
behind the Langevin step (:mod:`twoforone_torch.dynamics.integrators`), the
plain network's reverse step (:mod:`twoforone_torch.core.diffusion`), the
clx evaluation (:mod:`twoforone_torch.ops.fused_score_clx`) and the
training step and loss evaluation (:mod:`twoforone_torch.train.trainer`).

A graph replays the kernels recorded at its capture on the memory it read
and wrote then. So a captured function reads its inputs from static buffers
(:meth:`StepGraphs.buffer`) that the caller fills before each replay, writes
its results into static buffers or returns them (static outputs, which the
next replay overwrites), and holds no Python number that changes between
calls: it would be recorded as a constant.

A loop is written once, for both forms, through three functions of its
``graphs`` (a :class:`StepGraphs`, or None off the card as
:func:`graphs_for` gives it): :func:`static` hands the step body an input,
:func:`output` a tensor the body writes, and :func:`run` runs the body.
With None they are the eager loop (the input itself, a new tensor, a plain
call); with graphs the static buffers and the replay. Both forms run the
same step body, so they give the same bits.
"""

from __future__ import annotations

import time

import torch


def _counters():
    """(wrapper, attribute) of every kernel launch counter, in the order
    (K1, K2, K3, K4, K1's launches on clusters of blocks)."""
    from twoforone_torch.ops import attention_cl_core, fused_score, fused_score_cl

    return ((fused_score_cl.fused_force_cl, "launches"),
            (attention_cl_core.cl_attention_core, "launches_fwd"),
            (attention_cl_core.cl_attention_core, "launches_bwd"),
            (fused_score.fused_force, "launches"),
            (fused_score_cl.fused_force_cl, "clustered"))


def kernel_launches() -> tuple:
    """The launch counters of K1, K2, K3 and K4, and K1's clustered launches."""
    return tuple(getattr(fn, name) for fn, name in _counters())


def set_kernel_launches(counts) -> None:
    for (fn, name), count in zip(_counters(), counts):
        setattr(fn, name, count)


def add_kernel_launches(counts) -> None:
    set_kernel_launches(a + b for a, b in zip(kernel_launches(), counts))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)


class StepGraphs:
    """The CUDA graphs of one loop (a simulation, a sampling closure, a clx
    evaluation, a trainer's step or evaluation), keyed by the caller, on one
    side stream and one memory pool.

    ``graphs(key, fn)`` runs ``fn()``. The first call of a key runs it
    eagerly on the side stream (the warm-up, a real call: it loads the
    kernel libraries, sets their ``ctypes`` argument types and creates the
    cuBLAS workspace, none of which may happen inside a capture) and returns
    its result; it then records ``fn`` in a ``torch.cuda.CUDAGraph`` on the
    same stream. Later calls of the key replay the graph and return the
    outputs of the capture. ``fn`` itself is not called again, so the
    function of a later call is ignored. A capture that fails raises: there
    is no eager fallback on the card.

    Launch counters: a kernel wrapper counts a launch when it issues one,
    which during a capture only records it. The counts of the capture are
    therefore taken back, and a replay adds what the capture recorded.

    Capture counters, process-wide like the kernels' launch counters:
    ``StepGraphs.captures`` counts first calls of a key (each a warm-up and
    a capture), ``StepGraphs.capture_s`` adds their host seconds. A loop
    captures once a key, so a count above a run's steady value is a key
    captured again (a shape that changed, a new variant). Replays touch
    neither.

    All graphs of one object share a memory pool, so a loop with several
    step variants (the last hop of a strided chain) holds one step's
    activations, not one per variant. Each graph keeps ``fn`` alive, and
    with it every tensor its kernels read.
    """

    captures = 0
    capture_s = 0.0

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = {}
        self._buffers = {}
        self._stream = None
        self._pool = None

    def buffer(self, name, shape, dtype=torch.float32) -> torch.Tensor:
        """A static buffer: the same zero-initialised tensor at every call
        with this name, shape and dtype."""
        key = (name, tuple(shape), dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(shape, dtype=dtype, device=self.device)
        return self._buffers[key]

    def __call__(self, key, fn):
        entry = self.graphs.get(key)
        if entry is not None:
            graph, outputs, per_replay, _ = entry
            graph.replay()
            add_kernel_launches(per_replay)
            return outputs
        start = time.perf_counter()
        first = self._warm_up(fn)
        before = kernel_launches()
        try:
            graph, outputs = self._capture(fn)
        finally:
            recorded = tuple(a - b for a, b in zip(kernel_launches(), before))
            set_kernel_launches(before)
        self.graphs[key] = (graph, outputs, recorded, fn)
        StepGraphs.captures += 1
        StepGraphs.capture_s += time.perf_counter() - start
        return first

    def _warm_up(self, fn):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            first = fn()
        current.wait_stream(self._stream)
        for tensor in _tensors(first):
            tensor.record_stream(current)
        return first

    def _capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            outputs = fn()
        if self._pool is None:
            self._pool = graph.pool()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return graph, outputs


def graphs_for(device):
    """The :class:`StepGraphs` of a loop on ``device``: one on a CUDA device,
    None (the eager loop) elsewhere."""
    device = torch.device(device)
    return StepGraphs(device) if device.type == "cuda" else None


def run(graphs, key, fn):
    """``fn()`` eagerly when ``graphs`` is None, else replayed from ``graphs``
    under ``key`` (the first call of a key warms up and captures)."""
    return fn() if graphs is None else graphs(key, fn)


def static(graphs, name, value: torch.Tensor) -> torch.Tensor:
    """``value`` itself when eager, else copied into the static buffer
    ``name`` of ``graphs`` that the captured work reads."""
    if graphs is None:
        return value
    return graphs.buffer(name, value.shape, value.dtype).copy_(value)


def output(graphs, name, like: torch.Tensor) -> torch.Tensor:
    """Where work writes a result: a new zeroed tensor shaped like ``like``
    when eager, else the static buffer ``name`` of ``graphs``."""
    if graphs is None:
        return torch.zeros_like(like)
    return graphs.buffer(name, like.shape, like.dtype)
