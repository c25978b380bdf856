"""The Langevin step in its graphed form
(``twoforone_torch/dynamics/integrators.py::LangevinSimulation``).

On the card ``simulate`` replays a captured step that reads its noise and
inverse temperature from static buffers. Here the graphed loop
runs through the stand-in of ``test_torch_graph_capture.py`` (its replay runs
the recorded function on the static buffers), held bit for bit against the
eager loop of ``one_step``: BAOA(F)B and overdamped dynamics, the tempering
ramp, injected noise, saved forces and kinetic energies, the generator state
and a resumed run. The ``cuda`` tests hold the real graph against the eager
loop on the card (``python -m pytest tests/test_torch_graph_langevin.py -m
cuda --noconftest``; no JAX is imported).
"""

from functools import partial

import numpy as np
import pytest
import torch

from test_torch_graph_capture import StandInGraphs, one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.models.graph_transformer import GraphTransformer, init_params
from twoforone_torch.ops import fused_score_cl as fcl
from twoforone_torch.utils.cuda_graph import kernel_launches, run, set_kernel_launches, static

N = 6
EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)


def _diffusion():
    model = GraphTransformer(N, 16, 2, **EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=N, timesteps=100, norm_factor=1.7,
                           loss_weights="ones")
    return gd, init_params(model, 3)


def _init(chains, seed=0):
    x = np.random.default_rng(seed).normal(size=(chains, N, 3)).astype(np.float32)
    return (x - x.mean(axis=1, keepdims=True)) * 1.7


def _ld(friction=1.0, chains=5, steps=40, save_interval=10, device="cpu", fused="never",
        seed=0, bf16=False):
    gd, params = _diffusion()
    return LangevinDiffusion(
        gd, params, _init(chains), n_timesteps=steps, save_interval=save_interval, t=5,
        temp_data=300, temp_sim=300, dt=2e-3, masses=[12.0] * N, friction=friction,
        random_seed=seed, log=False, fused=fused, bf16=bf16, restraint_k=50.0, max_force=1e3,
        device=device)


def _run(ld, graphs, reference_temp=None, noise=None, splits=None):
    """Drive ``ld`` through the loop of ``graphs`` (None: eager), in
    ``splits`` simulate calls; returns everything a run leaves behind."""
    sim = ld.sim
    sim.save_forces = True
    sim._graphs = graphs
    if noise is not None:
        draws = iter(noise)
        sim._draw_noise = lambda like: next(draws)
    ref_beta = None if reference_temp is None else ld.kb_inv / reference_temp
    parts = []
    for n in splits or (sim.length,):
        coords = sim.simulate(sub_interval=n, reference_beta=ref_beta)
        parts.append((coords, sim.simulated_forces, sim.kinetic_energies))
    st = sim.state
    return dict(coords=np.concatenate([p[0] for p in parts], axis=1),
                forces=np.concatenate([p[1] for p in parts], axis=1),
                ke=None if parts[0][2] is None else np.concatenate([p[2] for p in parts], axis=1),
                x=st["x"], v=st["v"], t=st["t"], key=st["key"])


def _same(a, b):
    for name in a:
        if a[name] is None:
            assert b[name] is None, name
        else:
            assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name


@pytest.mark.parametrize("save_interval", [5, 7, 10])
@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_graphed_loop_equals_the_eager_loop(friction, save_interval):
    """Frames, forces, kinetic energies, the final x and v, the step count
    and the generator state, bit for bit; one graph of one step serves
    every step of the run, saved or not."""
    steps = 4 * save_interval
    eager = _run(_ld(friction, steps=steps, save_interval=save_interval), None)
    graphs = StandInGraphs()
    graphed = _run(_ld(friction, steps=steps, save_interval=save_interval), graphs)
    _same(eager, graphed)
    assert graphed["coords"].shape[1] == 4
    assert list(graphs.graphs) == [("step", (5, N, 3))]
    assert graphs.graphs[("step", (5, N, 3))][0].replays == steps - 1


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_graphed_tempering_ramp_equals_the_eager_loop(friction):
    """The ramp gives every step its own beta: a device buffer filled before
    each replay, not a constant of the capture."""
    eager = _run(_ld(friction, steps=80), None, reference_temp=600.0)
    graphed = _run(_ld(friction, steps=80), StandInGraphs(), reference_temp=600.0)
    _same(eager, graphed)
    flat = _run(_ld(friction, steps=80), StandInGraphs())
    assert not np.array_equal(flat["coords"], graphed["coords"])


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_graphed_loop_takes_injected_noise(friction):
    """Replacing ``_draw_noise`` (as the JAX-parity tests do) feeds the
    graph: the same numbers give the same trajectory."""
    noise = torch.from_numpy(np.random.default_rng(7).normal(size=(40, 5, N, 3)).astype(
        np.float32))
    eager = _run(_ld(friction), None, noise=noise)
    graphed = _run(_ld(friction), StandInGraphs(), noise=noise)
    _same(eager, graphed)
    drawn = _run(_ld(friction), StandInGraphs())
    assert not np.array_equal(drawn["coords"], graphed["coords"])


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_captured_step_on_static_buffers_equals_one_step(friction):
    """The step body ``simulate`` runs, captured once and replayed on the
    static buffers, against ``one_step`` from the same state with the same
    noise and beta, over steps of different betas."""
    ld = _ld(friction)
    sim = ld.sim
    graphs = StandInGraphs()
    x0, v0 = sim._init_state()
    x = graphs.buffer("x", x0.shape).copy_(x0)
    v = None if v0 is None else graphs.buffer("v", v0.shape).copy_(v0 + 0.3)
    betas = np.array([sim.beta, 0.9 * sim.beta, 1.1 * sim.beta], np.float32)
    coefs = torch.from_numpy(np.asarray(sim._step_coefficients(betas), np.float32))
    ex, ev = x0, None if v0 is None else v0 + 0.3
    key = ("step", tuple(x.shape))
    for j in range(3):
        noise = sim._draw_noise(x)
        step = partial(sim._step, x, v, static(graphs, "coef", coefs[j]),
                       static(graphs, "noise", noise))
        _, forces = run(graphs, key, step)
        ex, ev, _, ef = sim.one_step(ex, ev, float(betas[j]), noise)
        assert torch.equal(x, ex) and torch.equal(forces, ef)
        assert (v is None and ev is None) or torch.equal(v, ev)
    assert graphs.warm_ups == 1 and graphs.graphs[key][0].replays == 2


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_graphed_run_resumes_bit_for_bit(friction):
    """A graphed run stopped at a chunk boundary, its ``state`` loaded into a
    fresh simulation, continues the straight run bit for bit (both graphed),
    and the straight run equals the eager one."""
    straight = _run(_ld(friction, steps=60), StandInGraphs())
    first = _ld(friction, steps=60)
    part = _run(first, StandInGraphs(), splits=(30,))
    second = _ld(friction, steps=60)
    second.sim.load_state(first.sim.state)
    rest = _run(second, StandInGraphs(), splits=(30,))
    assert np.array_equal(np.concatenate([part["coords"], rest["coords"]], axis=1),
                          straight["coords"])
    _same({k: rest[k] for k in ("x", "v", "t", "key")},
          {k: straight[k] for k in ("x", "v", "t", "key")})
    _same(straight, _run(_ld(friction, steps=60), None))


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_state_does_not_alias_the_graphs_buffers(friction):
    ld = _ld(friction)
    graphs = StandInGraphs()
    ld.sim._graphs = graphs
    ld.sim.simulate(sub_interval=20)
    x_after_20 = ld.sim._state[0]
    kept = x_after_20.clone()
    assert x_after_20 is not graphs.buffer("x", x_after_20.shape)
    ld.sim.simulate(sub_interval=20)
    assert torch.equal(x_after_20, kept)


def test_kernel_launches_equal_steps_through_the_graphed_loop():
    """A force whose wrapper counts one launch a call (as K1's does): after
    the warm-up, the capture and the replays, exactly one a step."""
    ld = _ld(steps=100)
    force = ld.sim.force_fn

    def counting_force(x):
        fcl.fused_force_cl.launches += 1
        return force(x)

    ld.sim.force_fn = counting_force
    before = kernel_launches()
    set_kernel_launches((0, 0, 0, 0, 0))
    try:
        _run(ld, StandInGraphs())
        assert kernel_launches() == (100, 0, 0, 0, 0)
    finally:
        set_kernel_launches(before)


@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
def test_graphed_bf16_loop_equals_the_eager_loop(friction):
    _same(_run(_ld(friction, bf16=True), None), _run(_ld(friction, bf16=True), StandInGraphs()))


def test_cpu_simulation_runs_the_eager_loop():
    sim = _ld().sim
    assert sim._graphs is None


def test_clx_force_inside_the_step_is_the_eager_evaluation(monkeypatch):
    """The clx evaluation runs inside the step's capture, where it may not
    make a graph of its own: ``make_diffusion_force_fn`` builds it with
    ``graphed=False``."""
    from twoforone_torch.dynamics import langevin
    from twoforone_torch.ops import fused_score_clx

    seen = []
    real = fused_score_clx.make_clx_force_fn

    def spy(*args, **kwargs):
        seen.append(kwargs.get("graphed", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_score_clx, "make_clx_force_fn", spy)
    gd, params = _diffusion()
    langevin.make_diffusion_force_fn(gd, params, 5, 1.0, fused="clx", device="cpu")
    assert seen == [False]


def test_overdamped_coefficient_is_the_host_float64_value():
    """The graph's coefficient of a step, rounded to float32, is what the
    eager step's Python float becomes in a float32 product."""
    sim = _ld(friction=None).sim
    betas = np.array([0.3, sim.beta, 7.7], np.float32)
    coefs = sim._step_coefficients(betas)
    for b, c in zip(betas, coefs):
        eager = sim._step_coefficients(float(b))
        assert isinstance(eager, float)
        assert np.float32(eager) == c
        z = torch.tensor([1.0, -3.0, 0.7])
        assert torch.equal(eager * z, torch.tensor(c) * z)


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("friction", [1.0, None], ids=["baoab", "overdamped"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_graphed_plain_network_equals_eager_on_the_card(cuda_device, friction, bf16):
    """The real graph against the eager loop on the card, bit for bit, with
    the tempering ramp: 100 chains, 60 steps."""
    def run(graphed):
        ld = _ld(friction, chains=100, steps=60, device=cuda_device, bf16=bf16)
        graphs = ld.sim._graphs if graphed else None
        return _run(ld, graphs, reference_temp=450.0), graphs

    eager, _ = run(False)
    graphed, graphs = run(True)
    _same(eager, graphed)
    assert list(graphs.graphs) == [("step", (100, N, 3))]


@pytest.mark.cuda
def test_graphed_clustered_force_kernel_equals_eager_on_the_card(cuda_device):
    """K1 at 100 chains of 6 beads: 50 tiles of two chains, each shared by a
    cluster of 4 blocks. The captured step replays that launch with the bits
    of the eager step, and counts each replay's launch as clustered."""
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(graphed):
        ld = _ld(chains=100, steps=60, device=cuda_device, fused="cl")
        graphs = ld.sim._graphs if graphed else None
        before = (fcl.fused_force_cl.launches, fcl.fused_force_cl.clustered)
        out = _run(ld, graphs)
        return out, (fcl.fused_force_cl.launches - before[0],
                     fcl.fused_force_cl.clustered - before[1])

    eager, eager_counts = run(False)
    graphed, graphed_counts = run(True)
    _same(eager, graphed)
    assert graphed_counts == eager_counts and eager_counts[1] == eager_counts[0] >= 60
