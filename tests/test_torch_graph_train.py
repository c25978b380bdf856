"""The trainer's training step, its chunk and its loss evaluation in their
graphed form (``twoforone_torch/train/trainer.py``: ``Trainer._train_step``,
``_train_chunk``, ``eval_loss``), the counterparts of the JAX package's
jitted ``_train_step_impl``, ``_train_chunk_impl`` and ``_eval_loss_impl``.

On the card a step replays two captured halves (the gradients, then the
update) and an evaluation batch one captured loss. Here the stand-in of
``test_torch_graph_capture.py`` takes the CUDA graphs' place: its capture
runs the captured function's Python once more on fake tensors, as a real
capture does, so host state advanced inside a captured function would
advance twice and a read of a device value on the host would raise. Every
graphed run is held against the eager one bit for bit: each step's loss,
KL-at-T and running KL max, the weights, the EMA, Adam's moments and count,
the trainer's update count, the gradients left in ``.grad`` and the
generator's state. The EMA is given a short schedule (copy until call 3,
an update every 2 calls) so that a few steps cross its copy phase, its ramp
and its skipped calls. Nothing here imports JAX; the ``cuda`` tests need
the card (``python -m pytest tests/test_torch_graph_train.py -m cuda
--noconftest``).

Two gloo ranks: this file runs as a script (``python
tests/test_torch_graph_train.py RANK WORLD PORT FOLDER``), each rank the
eager and the graphed step on its rows of the same global batches.
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from test_torch_graph_capture import StandInGraphs, one_torch_thread  # noqa: F401 (autouse)
from test_torch_parallel import _chignolin_sets, _train_fields
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.models import get_model
from twoforone_torch.ops.geometry import random_rotation_matrices
from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed, local_rows
from twoforone_torch.train.ema import EMAConfig
from twoforone_torch.train.trainer import Trainer, batch_iterator
from twoforone_torch.utils.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORM = 1.6
BATCH = 8
STEPS = 8  # EMA calls 0, 2, 4 copy, 6 ramps; 1, 3, 5, 7 skip
EMA = dict(update_after_step=3, update_every=2)
RANKS = 2
RANK_TIMEOUT = 180  # seconds for the world, start-up included


def _trainer(folder, device="cpu", mesh=None, **overrides):
    """A chignolin trainer at nf 16, one layer, batch 8, with chain10's other
    published settings and the short EMA schedule."""
    fields = _train_fields(batch_size=BATCH, **overrides)
    cfg = TrainConfig.from_dict(dict(fields, results_folder=str(folder),
                                     tensorboard_folder=str(folder), data_folder=None))
    gd = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                           timesteps=cfg.diffusion_steps, norm_factor=NORM,
                           loss_weights=cfg.loss_weights)
    trainer = Trainer(gd, _chignolin_sets(), cfg.mol, cfg, mesh=mesh, use_tensorboard=False,
                      evaluators=False, device=device)
    trainer.ema_cfg = EMAConfig(beta=cfg.ema_decay, **EMA)
    return trainer


def _batches(trainer, n, accum=1, seed=3, rows=slice(None)):
    """``n`` steps' batches of the training split (``accum`` micro-batches
    each), this rank's ``rows`` of each."""
    it = batch_iterator(np.asarray(trainer.train_data.data), BATCH, seed=seed)
    out = [np.stack([next(it) for _ in range(accum)]) if accum > 1 else next(it)
           for _ in range(n)]
    return [b[..., rows, :, :] for b in out]


def _state(trainer, gen):
    """Everything a step leaves behind, on the host."""
    opt = trainer.optimizer
    moments = [(opt.state[p]["mu"].cpu(), opt.state[p]["nu"].cpu())
               for p in trainer.net.parameters()]
    return {"weights": {k: v.cpu() for k, v in trainer.net.state_dict().items()},
            "ema": {k: v.cpu() for k, v in trainer.ema.state_dict().items()},
            "grads": [p.grad.cpu() for p in trainer.net.parameters()],
            "moments": moments, "count": opt.param_groups[0]["count"],
            "step": trainer.step, "kl_max": trainer.kl_max.cpu(), "generator": gen.get_state()}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _steps(trainer, batches, graphs=None, seed=5, draws=None):
    """The steps of ``batches`` from a generator seeded ``seed``, graphed
    through ``graphs`` (a stand-in) or eagerly (None); returns each step's
    metrics on the host and the state after."""
    trainer._step_graphs = graphs
    gen = torch.Generator(trainer.device).manual_seed(seed)
    metrics = [trainer._train_step(b, gen, None if draws is None else draws[k])
               for k, b in enumerate(batches)]
    return [{k: v.cpu() for k, v in m.items()} for m in metrics], _state(trainer, gen)


def _pair(tmp_path, n=STEPS, accum=1, draws=None, **overrides):
    """The same steps eager and graphed, on two trainers built alike."""
    eager = _trainer(tmp_path / "eager", **overrides)
    graphed = _trainer(tmp_path / "graphed", **overrides)
    batches = _batches(eager, n, accum)
    graphs = StandInGraphs()
    return (_steps(eager, batches, draws=draws), _steps(graphed, batches, graphs, draws=draws),
            graphs, graphed)


CASES = {"float32": dict(), "accumulate_2": dict(accum=2, gradient_accumulate_every=2),
         "bfloat16": dict(bf16=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_steps_equal_eager_steps(tmp_path, case):
    """Eight steps across the EMA's copy, ramp and skipped calls: every
    metric and the whole state bit for bit. One graph of the gradients,
    captured at the first step, and one update graph for the calls that
    update the EMA and one for those that skip it."""
    (m_e, s_e), (m_g, s_g), graphs, trainer = _pair(tmp_path, **CASES[case])
    assert _same(m_g, m_e) and _same(s_g, s_e)
    assert s_g["step"] == s_g["count"] == STEPS
    accum = CASES[case].get("accum", 1)
    shape = (accum, BATCH, 10, 3)
    assert sorted(graphs.graphs, key=str) == sorted(
        [("gradients", shape), ("update", False), ("update", True)], key=str)
    assert graphs.warm_ups == graphs.captures == 3
    assert graphs.graphs[("gradients", shape)][0].replays == STEPS - 1
    assert graphs.graphs[("update", True)][0].replays == STEPS // 2 - 1
    # the EMA moved away from its copy, and the weights trained
    assert not _same(s_g["ema"], s_g["weights"])
    if case == "bfloat16":
        assert trainer.net.dtype == torch.bfloat16
        assert all(v.dtype == torch.float32 for v in s_g["weights"].values())


def test_injected_draws_graphed_equal_eager(tmp_path):
    """The JAX-parity tests inject another implementation's draws: the
    graphed step takes them into its static buffers as it takes its own."""
    rng = np.random.default_rng(0)
    draws = [[{"rotation": random_rotation_matrices(torch.Generator().manual_seed(k), BATCH),
               "t": torch.from_numpy(rng.integers(0, 1000, BATCH)),
               "noise": torch.from_numpy(rng.normal(size=(BATCH, 10, 3)).astype(np.float32))}]
             for k in range(4)]
    (m_e, s_e), (m_g, s_g), _, _ = _pair(tmp_path, n=4, draws=draws)
    assert _same(m_g, m_e) and _same(s_g, s_e)
    # nothing was drawn from the generator
    assert _same(s_g["generator"], torch.Generator().manual_seed(5).get_state())


def test_train_chunk_graphed_equals_single_eager_steps(tmp_path):
    """K steps in one ``_train_chunk`` call, graphed, equal K single eager
    steps; the chunk returns the last step's metrics."""
    eager, graphed = _trainer(tmp_path / "e"), _trainer(tmp_path / "g")
    batches = _batches(eager, 5)
    m_e, s_e = _steps(eager, batches)
    graphed._step_graphs = StandInGraphs()
    gen = torch.Generator().manual_seed(5)
    last = graphed._train_chunk(np.stack(batches), gen)
    assert _same(_state(graphed, gen), s_e)
    assert _same({k: v.cpu() for k, v in last.items()}, m_e[-1])


def test_eval_loss_graphed_equals_eager(tmp_path):
    """The EMA weights' mean loss over the validation batches: graphed (one
    captured evaluation, replayed for every batch and call) equals eager,
    and so does the generator's state after."""
    trainer = _trainer(tmp_path, iterations_on_val=1)
    _steps(trainer, _batches(trainer, 3))
    val = np.asarray(trainer.val_data.data)
    got = {}
    for graphs in (None, StandInGraphs()):
        trainer._eval_graphs = graphs
        gen = torch.Generator().manual_seed(9)
        got[graphs is None] = ([trainer.eval_loss(val, 3, gen), trainer.eval_loss(val, 2, gen)],
                               gen.get_state())
    assert got[True][0] == got[False][0] and _same(got[True][1], got[False][1])
    assert np.isfinite(got[False][0]).all() and got[False][0][0] != got[False][0][1]
    assert list(graphs.graphs) == [("eval", (BATCH, 10, 3))]
    assert graphs.graphs[("eval", (BATCH, 10, 3))][0].replays == 4


@pytest.mark.parametrize("same_trainer", [True, False])
def test_load_into_a_captured_trainer_continues_as_a_straight_run(tmp_path, same_trainer):
    """Save at step 4, train on, load the checkpoint into the trainer whose
    graphs were captured (or into a fresh graphed trainer) and continue from
    the generator state of step 4: the weights, EMA, moments and count equal
    a straight graphed run's. The graphs read the tensors ``load`` writes in
    place; the KL max starts again at the load, as in the JAX package."""
    straight = _trainer(tmp_path / "straight")
    batches = _batches(straight, STEPS)
    m_s, s_s = _steps(straight, batches, StandInGraphs())

    first = _trainer(tmp_path / "resumed")
    first._step_graphs = StandInGraphs()
    gen = torch.Generator().manual_seed(5)
    for b in batches[:4]:
        first._train_step(b, gen)
    first.save(1)
    at_save = gen.get_state()
    for b in batches[4:6]:  # moves every tensor the graphs read away from the checkpoint
        first._train_step(b, gen)
    resumed = first if same_trainer else _trainer(tmp_path / "resumed")
    if not same_trainer:
        resumed._step_graphs = StandInGraphs()
    resumed.load("last")
    assert resumed.step == 4 and float(resumed.kl_max) == 0.0
    gen.set_state(at_save)
    metrics = [resumed._train_step(b, gen) for b in batches[4:]]
    s_r = _state(resumed, gen)
    for key in ("weights", "ema", "grads", "moments", "count", "step", "generator"):
        assert _same(s_r[key], s_s[key]), key
    assert _same([m["loss"].cpu() for m in metrics], [m["loss"] for m in m_s[4:]])
    assert float(s_r["kl_max"]) == max(float(m["kl_at_T"]) for m in m_s[4:])


def test_each_step_returns_its_own_metrics(tmp_path):
    """Metrics kept across steps (as ``Trainer.train``'s callers keep them)
    hold each step's numbers, not the static buffers a later replay
    rewrites."""
    trainer = _trainer(tmp_path)
    trainer._step_graphs = StandInGraphs()
    gen = torch.Generator().manual_seed(5)
    kept = [trainer._train_step(b, gen) for b in _batches(trainer, 5)]
    losses = [float(m["loss"]) for m in kept]
    assert len(set(losses)) == 5
    eager = _trainer(tmp_path / "eager")
    m_e, _ = _steps(eager, _batches(eager, 5))
    assert losses == [float(m["loss"]) for m in m_e]
    assert [float(m["kl_max"]) for m in kept] == [float(m["kl_max"]) for m in m_e]


def test_host_counters_advance_once_a_step(tmp_path):
    """The update count, Adam's count and the schedule's position advance
    once a step although every captured function runs twice at its first
    call (warm-up and capture) in the stand-in, as on the card; the learning
    rate of each update is the schedule's at the count before it."""
    trainer = _trainer(tmp_path, train_iter=6)
    graphs = trainer._step_graphs = StandInGraphs()
    rates = []
    schedule = trainer.lr_schedule
    trainer.lr_schedule = lambda count: rates.append(count) or schedule(count)
    gen = torch.Generator().manual_seed(5)
    for k, b in enumerate(_batches(trainer, 6), start=1):
        trainer._train_step(b, gen)
        assert trainer.step == trainer.optimizer.param_groups[0]["count"] == k
    assert rates == list(range(6)) and graphs.captures == 3
    neg_lr = trainer.optimizer.param_groups[0]["device_scalars"][0]
    assert float(neg_lr) == -schedule(5)


# ------------------------------------------------------------ two gloo ranks
def _rank_main(rank, world, port, folder):
    """One rank: the eager and the graphed step on its rows of the same
    global batches, saved for the test."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout=timedelta(seconds=60))
    mesh = get_mesh("cpu")
    out = {}
    for graphed in (False, True):
        trainer = _trainer(os.path.join(folder, f"r{rank}{graphed}"), mesh=mesh)
        batches = _batches(trainer, 4, rows=local_rows(BATCH, mesh))
        out[graphed] = _steps(trainer, batches, StandInGraphs() if graphed else None)
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_two_gloo_ranks_graphed_equal_eager(tmp_path):
    """Two ranks on the CPU, the mesh's collectives between the two
    captured halves: on each rank the graphed steps equal the eager ones bit
    for bit, and both ranks hold the same weights."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(RANKS):
        logs.append(tmp_path / f"rank{r}.log")
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(RANKS), str(port),
                 str(tmp_path)], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(RANKS)]
    for res in ranks:
        assert _same(res[True], res[False])
    assert _same(ranks[0][True][1]["weights"], ranks[1][True][1]["weights"])
    assert _same(ranks[0][True][0], ranks[1][True][0])  # the metrics are global


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_training_equals_eager_on_the_card(tmp_path, cuda_device, case):
    """The trainer's own CUDA graphs against its eager step (reached through
    the private ``_step_graphs`` set to None), bit for bit."""
    overrides = {k: v for k, v in CASES[case].items() if k != "accum"}
    accum = CASES[case].get("accum", 1)
    eager = _trainer(tmp_path / "e", cuda_device, **overrides)
    graphed = _trainer(tmp_path / "g", cuda_device, **overrides)
    batches = _batches(eager, STEPS, accum)
    m_e, s_e = _steps(eager, batches)
    m_g, s_g = _steps(graphed, batches, graphed._step_graphs)
    assert _same(m_g, m_e) and _same(s_g, s_e)
    assert len(graphed._step_graphs.graphs) == 3


@pytest.mark.cuda
def test_eval_loss_graphed_equals_eager_on_the_card(tmp_path, cuda_device):
    trainer = _trainer(tmp_path, cuda_device)
    _steps(trainer, _batches(trainer, 3), trainer._step_graphs)
    val = np.asarray(trainer.val_data.data)
    graphs, got = trainer._eval_graphs, {}
    for g in (None, graphs):
        trainer._eval_graphs = g
        gen = torch.Generator(cuda_device).manual_seed(9)
        got[g is None] = [trainer.eval_loss(val, 3, gen), trainer.eval_loss(val, 2, gen)]
    assert got[True] == got[False] and len(graphs.graphs) == 1


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
