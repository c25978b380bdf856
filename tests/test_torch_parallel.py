"""The port's multi-GPU layer (``twoforone_torch/parallel``) on the CPU.

- The mesh's arithmetic, the no-op of ``initialize_distributed`` and the
  per-rank ``"auto"`` gate against the JAX package's.
- Several ranks: each test starts its own world of gloo processes on
  127.0.0.1 at a free port, one torch thread a rank. Every rank runs this
  file as a script (``python tests/test_torch_parallel.py CASE RANK WORLD
  PORT FOLDER``), joins with a 60 s rendezvous timeout, runs the case and
  saves what it got; the test waits for all of them within a time limit, so
  a hung rank fails that test. The script imports nothing of JAX: the JAX
  references are computed by the tests, in this process.

  Langevin and i.i.d. sampling over 4 ranks against 1 (the 1-rank Langevin
  run held against JAX's ``LangevinDiffusion(mesh=get_mesh())`` on the
  8-device CPU mesh with injected noise); a 4-rank training step against
  JAX's loss and gradient on the global batch (the oracle of
  ``tests/test_multihost.py``); a 2-rank ``Trainer.train``; the sampling CLI
  over 2 ranks; the train CLI's single-process ``--multihost`` line.

Tolerances: a sharded run does what the unsharded one does, chain for
chain, so with a score that treats each coordinate alone the reverse loops
agree bit for bit. The network on the CPU may round a batch of 2 otherwise
than a batch of 8: 1e-6 of the largest coordinate after 20 Langevin steps,
1e-5 of the largest sample after a 5-step reverse chain (float32 rounding
grown through the network and the chain). The JAX comparisons keep the
tolerances of ``test_torch_dynamics.py`` and ``test_torch_train.py``.
"""

import os
import shutil
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from twoforone_torch.core.diffusion import GaussianDiffusion  # noqa: E402
from twoforone_torch.models.graph_transformer import GraphTransformer, init_params  # noqa: E402
from twoforone_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    gather,
    get_mesh,
    initialize_distributed,
    local_rows,
    mesh_size,
    round_to_mesh,
)

EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
CHAIN10_NORM = 3.113133430480957
LANGEVIN = dict(t=20, temp_data=340, temp_sim=340, dt=2e-3, masses=[12.0] * 10,
                friction=1.0, kb="consistent")
CHAINS = 8
STEP_BATCH = 16  # the global batch of the 4-rank training step
NORM = 1.6  # tests/test_torch_train.py's norm factor
RANK_TIMEOUT = 180  # seconds for a whole world, start-up included
TOL_SHARD_LANGEVIN = 1e-6
TOL_SHARD_SAMPLE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- models
def _chain10():
    from twoforone_torch.utils.artifacts import load_ema_params

    model = GraphTransformer(10, 64, 3, **EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=10, timesteps=1000,
                           norm_factor=CHAIN10_NORM, loss_weights="higheruntil_100")
    return gd, load_ema_params("chain10")


def _tiny():
    model = GraphTransformer(10, 16, 1, **EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=10, timesteps=20, norm_factor=3.11)
    return gd, init_params(model, 0)


def _langevin_start():
    init = np.random.default_rng(5).normal(size=(CHAINS, 10, 3)).astype(np.float32)
    return (init - init.mean(axis=1, keepdims=True)) * CHAIN10_NORM


def _chignolin_sets(n=96):
    """tests/test_torch_train.py's chignolin datasets."""
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.data.synthetic import chain10_dataset

    data = chain10_dataset(n, seed=0)
    topo = load_pdb(os.path.join(FOLDED_PDB_DIR, "CLN025-0-c-alpha.pdb")).topology
    cut = (n // 2, 3 * n // 4)
    return tuple(CGDataset(d, topo, Molecules.CHIGNOLIN)
                 for d in (data[: cut[0]], data[cut[0]: cut[1]], data[cut[1]:]))


def _train_fields(**overrides):
    import json

    from twoforone_torch.utils.artifacts import trained_dir

    with open(os.path.join(trained_dir("chain10"), "config.json")) as f:
        fields = json.load(f)
    fields.update(hidden_features_gnn=16, num_layers_gnn=1, batch_size=STEP_BATCH,
                  steps_per_host_loop=1)
    fields.update(overrides)
    return fields


def _port_trainer(fields, folder, mesh=None):
    from twoforone_torch.models import get_model
    from twoforone_torch.train.trainer import Trainer
    from twoforone_torch.utils.config import TrainConfig

    cfg = TrainConfig.from_dict(dict(fields, results_folder=str(folder),
                                     tensorboard_folder=str(folder), data_folder=None))
    gd = GaussianDiffusion(model=get_model(cfg, 10), num_atoms=10,
                           timesteps=cfg.diffusion_steps, norm_factor=NORM,
                           loss_weights=cfg.loss_weights)
    return Trainer(gd, _chignolin_sets(), cfg.mol, cfg, mesh=mesh, use_tensorboard=False,
                   evaluators=False, device="cpu")


# ------------------------------------------------------ what a rank runs
def _case_langevin(mesh, folder):
    from twoforone_torch.dynamics.langevin import LangevinDiffusion

    gd, params = _chain10()
    ld = LangevinDiffusion(gd, params, _langevin_start(), n_timesteps=20, save_interval=10,
                           random_seed=3, log=False, device="cpu", mesh=mesh, **LANGEVIN)
    traj = ld.sample()
    return {"traj": torch.from_numpy(traj), "state_x": torch.from_numpy(ld.sim.state["x"]),
            "local_x": ld.sim._state[0], "mode": ld.force_fn.mode}


def _elementwise_score(x, t_norm):
    """A score that treats every coordinate alone, so that a chain's numbers
    cannot depend on the batch it is computed in."""
    return 0.5 * x * t_norm[:, None, None]


def _case_sample(mesh, folder):
    from twoforone_torch.core.diffusion import (
        ddim_sample_loop,
        dpm_solver_pp_2m_loop,
        p_sample_loop,
    )

    gd, params = _tiny()
    buf = GaussianDiffusion(model=gd.model, num_atoms=10).buffers  # T = 1000
    out = {}
    for name, loop, kw in (("ancestral_loop", p_sample_loop, {}),
                           ("ddim_loop", ddim_sample_loop, dict(sample_steps=50, eta=1.0)),
                           ("dpm2m_loop", dpm_solver_pp_2m_loop, dict(sample_steps=50))):
        rows = loop(buf, _elementwise_score, (CHAINS, 10, 3),  # this rank's rows
                    torch.Generator().manual_seed(4), device="cpu", mesh=mesh, **kw)
        assert rows.shape == (CHAINS // mesh_size(mesh), 10, 3)
        out[name] = gather(rows, mesh)
    for name, kw in (("ddim", dict(sample_steps=5, eta=1.0)),
                     ("dpm2m", dict(sample_steps=5, solver="dpm2m"))):
        out[name] = gd.sample(params, CHAINS, torch.Generator().manual_seed(4), device="cpu",
                              mesh=mesh, **kw)
    fused = gd.make_fused_sample_fn(params, CHAINS, kernel="cl", sample_steps=5, device="cpu",
                                    mesh=mesh)
    out["fused"] = fused(torch.Generator().manual_seed(4))
    return out


def _case_train_step(mesh, folder):
    inputs = torch.load(os.path.join(folder, "inputs.pt"))
    trainer = _port_trainer(_train_fields(), os.path.join(folder, f"r{mesh.rank}"), mesh)
    trainer.net.load_state_dict(inputs["weights"])
    rows = local_rows(STEP_BATCH, mesh)
    metrics = trainer._train_step(inputs["batch"][rows].numpy(), torch.Generator(),
                                  draws=[inputs["draws"]])
    return {"grads": {n: p.grad for n, p in trainer.net.named_parameters()},
            "weights": trainer.net.state_dict(), "ema": trainer.ema.state_dict(),
            "loss": float(metrics["loss"]), "kl": float(metrics["kl_at_T"]),
            "local_batch": trainer.local_batch}


def _case_train(mesh, folder):
    fields = _train_fields(train_iter=4, eval_interval=4, num_samples_final_eval=STEP_BATCH,
                           iterations_on_val=1, experiment_name="shared")
    trainer = _port_trainer(fields, folder, mesh)
    trainer.train()
    return {"ema": trainer.ema.state_dict(), "weights": trainer.net.state_dict(),
            "samples": torch.from_numpy(trainer.sample(STEP_BATCH,
                                                       torch.Generator().manual_seed(1))),
            "step": trainer.step, "best_val_loss": trainer.best_val_loss,
            "folder": trainer.results_folder}


CLI_ARGS = ["--gen_mode", "langevin", "--parallel_sim", "5", "--batch_size_gen", "4",
            "--n_timesteps", "20", "--save_interval", "10", "--sample_steps", "3",
            "--device", "cpu"]


def _case_cli(mesh, folder):
    from twoforone_torch.cli.sample import main

    path = os.path.join(folder, f"chain10_r{mesh.rank}")
    return {"out": torch.from_numpy(main(["--model_path", path, *CLI_ARGS]))}


CASES = {"langevin": _case_langevin, "sample": _case_sample, "train_step": _case_train_step,
         "train": _case_train, "cli": _case_cli}


def _rank_main(case, rank, world, port, folder):
    """One rank: join the world (the CLI case through torchrun's
    environment, the others explicitly), run the case, save its result."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    timeout = timedelta(seconds=60)
    if case == "cli":
        assert initialize_distributed(device="cpu", timeout=timeout)
    else:
        assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                                      timeout=timeout)
    mesh = get_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (world, rank, "gloo")
    result = CASES[case](mesh, folder)
    torch.save(result, os.path.join(folder, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(case, world, folder):
    """Start ``world`` ranks of ``case`` and wait for them all within
    RANK_TIMEOUT; returns each rank's result and output."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    procs, logs = [], []
    for r in range(world):
        rank_env = env
        if case == "cli":  # what torchrun sets
            rank_env = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                            WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                            LOCAL_WORLD_SIZE=str(world))
        logs.append(os.path.join(folder, f"rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
                 str(port), str(folder)], cwd=REPO, env=rank_env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: a rank of {world} did not finish within {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [open(f).read() for f in logs]
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"{case}: rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [torch.load(os.path.join(folder, f"rank{r}.pt")) for r in range(world)], texts


def _scale(a):
    return float(np.abs(np.asarray(a)).max())


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_mesh_arithmetic_and_trainer_batches_match_jax(world, tmp_path, monkeypatch):
    """round_to_mesh, mesh_size and the trainer's global and local batch:
    the JAX package's at ``world`` devices, one a process (its local batch
    is the global one over ``jax.process_count()``)."""
    import jax

    from tests.test_train import _synthetic_ala2_dataset
    from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
    from twoforone_tpu.models import get_model as jget_model
    from twoforone_tpu.parallel import mesh as jmesh
    from twoforone_tpu.train.trainer import Trainer as JTrainer
    from twoforone_tpu.utils.config import TrainConfig as JConfig
    from twoforone_torch.models import get_model
    from twoforone_torch.train.trainer import Trainer
    from twoforone_torch.utils.config import TrainConfig

    jm = jmesh.get_mesh(jax.devices()[:world])
    mesh = Mesh(world, 0, torch.device("cpu"))
    assert mesh_size(mesh) == jmesh.mesh_size(jm) == world
    assert mesh_size(None) == jmesh.mesh_size(None) == 1
    for n in (1, 5, 8, 30, 999, 1000):
        assert round_to_mesh(n, mesh) == jmesh.round_to_mesh(n, jm)
        assert round_to_mesh(n, None) == n

    fields = dict(mol="alanine_dipeptide_fuberlin", hidden_features_gnn=8, num_layers_gnn=1,
                  batch_size=30, data_folder=None, results_folder=str(tmp_path))
    data = _synthetic_ala2_dataset(256)
    jcfg = JConfig(**fields)
    jgd = JGD(model=jget_model(jcfg, 5), num_atoms=5, timesteps=100)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    jt = JTrainer(jgd, data, jcfg.mol, jcfg, mesh=jm, use_tensorboard=False, evaluators=False)
    monkeypatch.undo()
    cfg = TrainConfig(**fields)
    ours = Trainer(GaussianDiffusion(model=get_model(cfg, 5), num_atoms=5, timesteps=100),
                   data, cfg.mol, cfg, mesh=mesh, use_tensorboard=False, evaluators=False,
                   device="cpu")
    assert (ours.batch_size, ours.local_batch) == (jt.batch_size, jt.local_batch)
    assert ours.local_batch * world == ours.batch_size <= 30


def test_initialize_distributed_single_process_noop(monkeypatch):
    """Nothing configured: a no-op that returns False, as in JAX's
    tests/test_sharding.py; a world of one afterwards."""
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()
    assert get_mesh("cpu") == Mesh(1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="no coordinator"):
        initialize_distributed(num_processes=2, process_id=0, device="cpu")


def test_default_backend(monkeypatch):
    """NCCL for a GPU, gloo for the CPU, and gloo when the ranks of one host
    all name one card (NCCL refuses two ranks on one device)."""
    from twoforone_torch.parallel.mesh import default_backend

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert default_backend("cpu") == "gloo"
    assert default_backend("cuda") == default_backend("cuda:0") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert default_backend("cuda") == "nccl"  # cuda:{LOCAL_RANK}: a card a rank
    assert default_backend(torch.device("cuda", 0)) == "gloo"
    assert default_backend("cpu") == "gloo"


def test_auto_gate_sees_the_chains_of_one_rank(monkeypatch):
    """The decisions of tests/test_sharding.py's gate test: 1024 chains over
    8 ranks is 128 a rank, the plain network; over 1 rank it is clx. The
    entry points hand the gate the per-rank count (recorded here on a CPU
    mesh, since no card is needed to see what they pass)."""
    from twoforone_tpu.dynamics.langevin import resolve_fused_mode as jresolve
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
    from twoforone_torch.dynamics import langevin
    from twoforone_torch.ops import fused_score_clx

    model = GraphTransformer(20, 16, 1, heads=2, dim_head=4, **EDGES)
    jmodel = JGT(num_beads=20, hidden_nf=16, n_layers=1, **EDGES)
    for ranks, expected in ((8, "never"), (1, "clx")):
        per_rank = 1024 // mesh_size(Mesh(ranks, 0, torch.device("cuda", 0)))
        assert langevin.resolve_fused_mode(model, "auto", per_rank, "cuda") == expected
        assert jresolve(jmodel, "auto", per_rank, "tpu") == expected

    seen = []
    real = fused_score_clx.auto_fused_path
    monkeypatch.setattr(fused_score_clx, "auto_fused_path",
                        lambda m, n, dev, **kw: seen.append(n) or real(m, n, dev, **kw))
    gd = GaussianDiffusion(model=model, num_atoms=20, timesteps=20)
    params = init_params(model, 0)
    mesh = Mesh(8, 3, torch.device("cpu"))
    langevin.make_diffusion_force_fn(gd, params, 5, 1.0, fused="auto", n_chains=1024,
                                     device="cpu", mesh=mesh)
    gd.make_fused_sample_fn(params, 1024, kernel="auto", sample_steps=2, device="cpu",
                            mesh=mesh)
    assert seen == [128, 128]


def test_four_rank_langevin_equals_one_rank_and_jax(tmp_path):
    """Chignolin (staged chain10 weights, plain network), 8 chains over 4
    ranks: the gathered trajectory and state equal the 1-rank run within
    1e-6 of the largest coordinate, every rank holds the same, and each
    holds its 2 chains. The 1-rank run with injected noise against the JAX
    BAOAB loop on the state that JAX's ``LangevinDiffusion(mesh=get_mesh())``
    places on its 8-device mesh (1e-4 of the largest coordinate, as
    test_torch_dynamics.py)."""
    import jax
    import jax.numpy as jnp

    from twoforone_tpu.dynamics import integrators as jint
    from twoforone_tpu.dynamics.langevin import LangevinDiffusion as JLD
    from twoforone_tpu.ops.geometry import center_zero as jcenter
    from twoforone_tpu.parallel.mesh import chain_sharding
    from twoforone_tpu.parallel.mesh import get_mesh as jget_mesh
    from twoforone_tpu.utils.artifacts import load_ema_params as jload
    from twoforone_torch.dynamics.langevin import LangevinDiffusion

    results, _ = _run_ranks("langevin", 4, tmp_path)
    ref = _case_langevin(None, tmp_path)
    scale = _scale(ref["traj"])
    for r, got in enumerate(results):
        assert got["mode"] == "never"
        assert got["traj"].shape == (CHAINS * 2, 10, 3)
        assert torch.equal(got["traj"], results[0]["traj"])
        assert torch.equal(got["state_x"], results[0]["state_x"])
        assert torch.equal(got["local_x"], got["state_x"][2 * r: 2 * r + 2])
    np.testing.assert_allclose(results[0]["traj"].numpy(), ref["traj"].numpy(),
                               atol=TOL_SHARD_LANGEVIN * scale, rtol=0)
    np.testing.assert_allclose(results[0]["state_x"].numpy(), ref["state_x"].numpy(),
                               atol=TOL_SHARD_LANGEVIN * scale, rtol=0)

    # The 1-rank run against JAX's sharded LangevinDiffusion, with the same noise.
    from __graft_entry__ import _flagship

    _, jgd = _flagship()
    jparams = jload(jgd, "chain10")
    jm = jget_mesh()
    init = _langevin_start()
    noise = np.random.default_rng(6).normal(size=(10, CHAINS, 10, 3)).astype(np.float32)
    jd = JLD(jgd, jparams, init, n_timesteps=10, save_interval=10, log=False, mesh=jm,
             **LANGEVIN)
    sim = jd.sim
    x, v = sim._state if sim._state is not None else sim._init_state()
    assert len(x.sharding.device_set) == 8
    force_fn = jax.jit(sim.force_fn)
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        step_noise = jax.device_put(jnp.asarray(noise[k]), chain_sharding(jm))
        x, v = jint.baoab_step(x, v, forces, step_noise, sim.dt, sim._masses, sim.vscale,
                               sim.noisescale, sim.beta)
    jref = np.asarray(x) * jd.norm_factor

    gd, params = _chain10()
    td = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                           device="cpu", mesh=get_mesh("cpu"), **LANGEVIN)
    draws = iter(torch.from_numpy(noise))
    td.sim._draw_noise = lambda like: next(draws)
    out = td.sample()
    np.testing.assert_allclose(out, jref, atol=1e-4 * _scale(jref), rtol=0)


def test_four_rank_sampling_equals_one_rank(tmp_path):
    """Over 4 ranks, under the same generator as one rank:

    - the three reverse loops (ancestral, DDIM with eta 1, so that every
      step draws noise, and DPM-Solver++(2M)) with a score that treats each
      coordinate alone give the 1-rank samples bit for bit: each rank draws
      the whole batch's noise and keeps its rows;
    - GaussianDiffusion.sample(mesh=) through the network (DDIM and
      DPM-Solver++(2M)) gives them within 1e-5 of the largest sample;
    - the fused path (the cl kernel's plain version on the CPU) samples 2 a
      rank from generators that differ by rank: i.i.d. samples, no two
      ranks' blocks alike.

    Every rank gets the same gathered samples."""
    results, _ = _run_ranks("sample", 4, tmp_path)
    ref = _case_sample(None, tmp_path)
    for name in ("ancestral_loop", "ddim_loop", "dpm2m_loop", "ddim", "dpm2m"):
        for got in results:
            assert got[name].shape == (CHAINS, 10, 3)
            assert torch.equal(got[name], results[0][name])
        if name.endswith("_loop"):
            assert torch.equal(results[0][name], ref[name]), name
        else:
            np.testing.assert_allclose(results[0][name].numpy(), ref[name].numpy(),
                                       atol=TOL_SHARD_SAMPLE * _scale(ref[name]), rtol=0)
    fused = results[0]["fused"]
    assert fused.shape == (CHAINS, 10, 3) and bool(torch.isfinite(fused).all())
    assert all(torch.equal(got["fused"], fused) for got in results)
    blocks = fused.reshape(4, 2, 10, 3)
    assert not any(torch.allclose(blocks[a], blocks[b]) for a in range(4) for b in range(a))


def test_four_rank_training_step_matches_jax(tmp_path):
    """One Trainer step over 4 ranks (4 rows each of a global batch of 16,
    with JAX's draws for the global batch injected): identical weights, EMA
    and gradient on every rank; the loss and KL-at-T of the global batch;
    each gradient leaf against ``jax.value_and_grad`` of the JAX loss on the
    global batch at test_torch_train.py's tolerance (1e-4 of the leaf's
    scale plus JAX's own distance from float64)."""
    import jax
    import jax.numpy as jnp

    from test_torch_checkpoint import _leaves
    from test_torch_train import _jax_step_draws, _leaf, _torch_f64_grads
    from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
    from twoforone_tpu.core.diffusion import normal_kl_at_T as jkl
    from twoforone_tpu.models import get_model as jget_model
    from twoforone_tpu.ops.geometry import random_rotation as jrandom_rotation
    from twoforone_tpu.utils.config import TrainConfig as JConfig
    from twoforone_torch.data.synthetic import chain10_dataset
    from twoforone_torch.utils.convert import params_from_jax, params_to_jax

    fields = _train_fields()
    trainer = _port_trainer(fields, tmp_path / "oracle")
    params = init_params(trainer.gd.model, 3)
    jcfg = JConfig.from_dict(fields)
    jgd = JGD(model=jget_model(jcfg, 10), num_atoms=10, timesteps=1000, norm_factor=NORM,
              loss_weights=jcfg.loss_weights)
    batch = chain10_dataset(STEP_BATCH, seed=5)
    aug_key, loss_key, draws = _jax_step_draws(jax.random.PRNGKey(7), jgd, batch)
    mb = jrandom_rotation(jnp.asarray(batch), aug_key)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgd.loss(p, mb, loss_key), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    torch.save({"weights": params_from_jax(params), "batch": torch.from_numpy(batch),
                "draws": draws}, tmp_path / "inputs.pt")

    results, _ = _run_ranks("train_step", 4, tmp_path)
    first = results[0]
    for got in results:
        assert got["local_batch"] == STEP_BATCH // 4
        for key in ("grads", "weights", "ema"):
            assert all(torch.equal(got[key][n], first[key][n]) for n in first[key])
        assert got["loss"] == first["loss"]
    assert first["loss"] == pytest.approx(float(jloss), rel=1e-5)
    # KL-at-T against the JAX function on the normalized global batch,
    # unjitted, as test_torch_train.py holds it.
    xj = (mb - mb.mean(axis=1, keepdims=True)) / NORM
    assert first["kl"] == pytest.approx(float(jkl(jgd.buffers, xj)), rel=1e-5)

    got = params_to_jax(first["grads"])
    ref64 = _torch_f64_grads(trainer, params, batch, draws)
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(jleaves) == set(dict(_leaves(got)))
    largest = max(np.abs(g).max() for g in jleaves.values())
    for path, jg in jleaves.items():
        g, g64 = _leaf(got, path), _leaf(ref64, path)
        scale = max(np.abs(jg).max(), 1e-2 * largest)
        tol = 1e-4 * scale + np.abs(jg - g64).max()
        assert np.abs(g - jg).max() <= tol, (path, np.abs(g - jg).max() / scale)


def test_two_rank_trainer_train(tmp_path):
    """Trainer.train over 2 ranks that share one results folder (4 steps,
    one evaluation, the final i.i.d. samples): both end with the same
    weights, EMA, samples and best validation loss; both wrote their
    checkpoints into the folder, and rank 0 alone the samples."""
    results, _ = _run_ranks("train", 2, tmp_path)
    a, b = results
    assert a["step"] == b["step"] == 4
    assert a["best_val_loss"] == b["best_val_loss"] and np.isfinite(a["best_val_loss"])
    for key in ("ema", "weights"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])
    assert torch.equal(a["samples"], b["samples"])
    assert a["samples"].shape == (STEP_BATCH, 10, 3) and bool(torch.isfinite(a["samples"]).all())
    files = sorted(os.listdir(a["folder"]))
    assert files == ["config.json", "model-best.msgpack", "model-last.msgpack",
                     "sample-final_iid.npy", "sample-final_iid.pdb"], files


def test_sampling_cli_two_ranks_pads_and_rank0_writes(tmp_path):
    """cli.sample under 2 ranks configured as torchrun configures them, each
    on its own copy of chain10: --parallel_sim 5 pads to 6, the output has 5
    chains' frames on both ranks, and only rank 0 writes files."""
    from twoforone_torch.utils.artifacts import trained_dir

    for r in range(2):
        shutil.copytree(trained_dir("chain10"), tmp_path / f"chain10_r{r}")
    results, logs = _run_ranks("cli", 2, tmp_path)
    assert all("Sharding over 2 devices (batch 4, parallel_sim 6)" in t for t in logs)
    out = results[0]["out"]
    assert out.shape == (5 * 20 // 10, 10, 3) and bool(torch.isfinite(out).all())
    assert torch.equal(results[1]["out"], out)
    written = tmp_path / "chain10_r0" / "main_eval_output_langevin"
    assert sorted(os.listdir(written)) == ["sample-langevin.npy", "sample-langevin.pdb",
                                           "sample-langevin.pt"]
    np.testing.assert_array_equal(np.load(written / "sample-langevin.npy"), out.numpy())
    assert os.listdir(tmp_path / "chain10_r1" / "main_eval_output_langevin") == []


def test_train_cli_multihost_without_coordinator_prints_the_no_op_line(tmp_path, monkeypatch,
                                                                       capsys):
    import twoforone_torch.cli.train as tcli

    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    coords = np.random.default_rng(0).normal(size=(64, 5, 3)).astype(np.float32)
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "ala2_cg_2fs_Hmass_2_HBonds.npz", coords=coords)
    trainer = tcli.main([
        "--multihost", "true", "--data_folder", str(tmp_path / "data"),
        "--results_folder", str(tmp_path / "out"), "--tensorboard_folder", str(tmp_path / "tb"),
        "--hidden_features_gnn", "8", "--num_layers_gnn", "1", "--batch_size", "4",
        "--train_iter", "1", "--eval_interval", "10", "--num_samples_final_eval", "2",
        "--diffusion_steps", "100", "--ala2_train_cap", "12", "--device", "cpu"])
    assert "multihost: no coordinator configured; single-process run" in capsys.readouterr().out
    assert trainer.mesh is None and trainer.local_batch == trainer.batch_size == 4


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
