"""The plain network's reverse step in its graphed form
(``twoforone_torch/core/diffusion.py``, ``make_sample_fn`` and
``make_fused_sample_fn(kernel="xla")``).

On the card a sampling closure of the plain network replays one captured
reverse step with its timesteps in 0-d device scalars. Here its graphed
loops run through the stand-in of ``test_torch_graph_capture.py`` (the
replay runs the recorded step on the static buffers) and are held bit for
bit against the eager loops: ancestral, DDIM (deterministic and with noise)
and DPM-Solver++(2M), from a generator or a noise hook, over repeated calls
of one closure, in bfloat16 and on one rank's rows of a mesh. The ``cuda``
tests hold the real graphs against the eager loops on the card
(``python -m pytest tests/test_torch_graph_sampler.py -m cuda --noconftest``;
no JAX is imported).
"""

import numpy as np
import pytest
import torch

from test_torch_graph_capture import StandInGraphs, one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.parallel.mesh import Mesh

N = 6
T = 40
EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
SAMPLERS = {
    "ancestral": dict(sample_steps=None),
    "ddim": dict(sample_steps=8),
    "ddim_eta1": dict(sample_steps=8, eta=1.0),
    "ddim_one_hop": dict(sample_steps=1),
    "dpm2m": dict(sample_steps=8, solver="dpm2m"),
    "dpm2m_two_steps": dict(sample_steps=2, solver="dpm2m"),
    "dpm2m_one_hop": dict(sample_steps=1, solver="dpm2m"),
}
# Graphs a closure captures: one step (ancestral), the final hop of the
# strided chains, the first-order first update of DPM-Solver++(2M).
VARIANTS = {"ancestral": 1, "ddim": 2, "ddim_eta1": 2, "ddim_one_hop": 1, "dpm2m": 3,
            "dpm2m_two_steps": 2, "dpm2m_one_hop": 1}


def _gd():
    model = GraphTransformer(N, 16, 2, **EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=N, timesteps=T, norm_factor=1.7,
                           loss_weights="ones")
    return gd, init_params(model, 4)


def _closures(name, batch=6, device="cpu", mesh=None, bf16=False, fused=False):
    """An eager and a graphed closure of the same sampler."""
    gd, params = _gd()
    kw = SAMPLERS[name]
    if fused:
        eager = gd.make_fused_sample_fn(params, batch, kernel="xla", device=device, mesh=mesh,
                                        **kw)
        graphed = gd.make_fused_sample_fn(params, batch, kernel="xla", device=device,
                                          mesh=mesh, **kw)
    else:
        eager = gd.make_sample_fn(params, batch, bf16=bf16, device=device, mesh=mesh, **kw)
        graphed = gd.make_sample_fn(params, batch, bf16=bf16, device=device, mesh=mesh, **kw)
    return eager, graphed


def _hook(seed):
    table = {}

    def noise(tag, shape):
        key = (tag, tuple(shape))
        if key not in table:
            table[key] = np.random.default_rng(
                (seed, 10**6 if tag == "init" else tag)).normal(size=shape).astype(np.float32)
        return table[key]
    return noise


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_graphed_chain_equals_the_eager_chain(name):
    """Three calls of one closure (the first captures, the rest replay every
    step) against the eager closure, from one generator each: the same
    samples bit for bit, and the generators end in the same state."""
    eager, graphed = _closures(name)
    graphs = StandInGraphs()
    graphed._graphs = graphs
    gen_e, gen_g = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    for _ in range(3):
        a, b = eager(gen_e), graphed(gen_g)
        assert torch.equal(a, b)
    assert torch.equal(gen_e.get_state(), gen_g.get_state())
    assert len(graphs.graphs) == VARIANTS[name]
    assert graphs.warm_ups == VARIANTS[name]


@pytest.mark.parametrize("name", ["ancestral", "ddim_eta1", "dpm2m"])
def test_graphed_chain_takes_the_noise_hook(name):
    eager, graphed = _closures(name)
    graphed._graphs = StandInGraphs()
    assert torch.equal(eager(noise=_hook(0)), graphed(noise=_hook(0)))
    assert torch.equal(eager(noise=_hook(1)), graphed(noise=_hook(1)))


@pytest.mark.parametrize("name", ["ancestral", "ddim", "dpm2m"])
def test_graphed_fused_closure_on_the_plain_network(name):
    """``make_fused_sample_fn(kernel="xla")`` is the same graphed loop."""
    eager, graphed = _closures(name, fused=True)
    graphed._graphs = StandInGraphs()
    gen_e, gen_g = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    for _ in range(2):
        assert torch.equal(eager(gen_e), graphed(gen_g))


@pytest.mark.parametrize("name", ["ancestral", "ddim", "dpm2m"])
def test_graphed_bf16_chain_equals_the_eager_chain(name):
    eager, graphed = _closures(name, bf16=True)
    graphed._graphs = StandInGraphs()
    gen_e, gen_g = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(eager(gen_e), graphed(gen_g))


@pytest.mark.parametrize("rank", [0, 1])
def test_graphed_chain_on_one_ranks_rows(rank):
    """Under a mesh each rank draws the whole batch's noise and keeps its
    rows, outside the graph: a rank's graphed rows are its eager rows (a
    process-free mesh of two, whose gather is a no-op)."""
    mesh = Mesh(2, rank, torch.device("cpu"))
    eager, graphed = _closures("ddim_eta1", batch=8, mesh=mesh)
    graphed._graphs = StandInGraphs()
    gen_e, gen_g = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = eager(gen_e), graphed(gen_g)
    assert a.shape == (4, N, 3) and torch.equal(a, b)


def test_graphed_step_reads_timesteps_from_device_scalars():
    """The captured step holds its timesteps in 0-d long buffers, filled
    before each replay, not as constants of the capture."""
    eager, graphed = _closures("ddim")
    graphs = StandInGraphs()
    graphed._graphs = graphs
    graphed(torch.Generator().manual_seed(0))
    t = graphs.buffer("t", (), torch.long)
    t_prev = graphs.buffer("t_prev", (), torch.long)
    assert int(t) == 0 and int(t_prev) == 0  # the final hop, from tau 0
    assert t.dtype == torch.long and t.shape == ()


def test_cpu_closures_run_the_eager_loops():
    gd, params = _gd()
    assert gd.make_sample_fn(params, 4, device="cpu")._graphs is None
    assert gd.make_fused_sample_fn(params, 4, kernel="xla", device="cpu")._graphs is None


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ancestral", "ddim_eta1", "dpm2m"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_graphed_chain_equals_eager_on_the_card(cuda_device, name, bf16):
    eager, graphed = _closures(name, batch=256, device=cuda_device, bf16=bf16)
    assert graphed._graphs is not None
    eager._graphs = None
    gen_e = torch.Generator(cuda_device).manual_seed(1)
    gen_g = torch.Generator(cuda_device).manual_seed(1)
    for _ in range(2):
        assert torch.equal(eager(gen_e), graphed(gen_g))
    assert len(graphed._graphs.graphs) == VARIANTS[name]


@pytest.mark.cuda
def test_one_shot_sample_is_eager_on_the_card(cuda_device, monkeypatch):
    from twoforone_torch.utils import cuda_graph

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was captured for one call")

    monkeypatch.setattr(cuda_graph.StepGraphs, "_capture", no_graph)
    gd, params = _gd()
    out = gd.sample(params, 16, torch.Generator(cuda_device).manual_seed(0), sample_steps=4,
                    device=cuda_device)
    assert out.shape == (16, N, 3)
