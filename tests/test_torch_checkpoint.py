"""Port's checkpoint reader, weight carry-over, import rule and device rule."""

import ast
import os

import numpy as np
import pytest
import torch
from flax import serialization

from twoforone_torch.utils.artifacts import load_ema_params, trained_dir
from twoforone_torch.utils.checkpoint import msgpack_restore, read_checkpoint
from twoforone_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "twoforone_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread while a module's tests run. The suite runs
    several pytest-xdist workers on the host's cores, and torch's thread
    pool in each of them oversubscribes the cores: the training loops of
    ``test_torch_train.py`` ran ~50x slower with six workers so."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_msgpack_reader_matches_flax_on_chain10():
    """Leaf for leaf, exactly: same tree, same types, dtypes, shapes, bytes."""
    path = os.path.join(trained_dir("chain10"), "model-best.msgpack")
    ours = read_checkpoint(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    ours_l, ref_l = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours_l.keys() == ref_l.keys()
    assert len(ref_l) == 244
    for k, r in ref_l.items():
        o = ours_l[k]
        assert type(o) is type(r), k
        assert np.asarray(o).dtype == np.asarray(r).dtype, k
        np.testing.assert_array_equal(o, r, err_msg=k)


def test_msgpack_reader_scalars_strings_and_chunks():
    tree = {
        "a": np.arange(6, dtype=np.int32).reshape(2, 3),
        "s": "text",
        "i": -7,
        "big": 2**40,
        "f": 1.5,
        "np": np.float64(2.25),
        "nested": {"b": np.ones((0, 4), np.float32), "flag": True, "none": None},
    }
    data = serialization.msgpack_serialize(tree)
    out = msgpack_restore(data)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert out["s"] == "text" and out["i"] == -7 and out["big"] == 2**40
    assert out["f"] == 1.5 and out["np"] == 2.25
    assert out["nested"]["b"].shape == (0, 4)
    assert out["nested"]["flag"] is True and out["nested"]["none"] is None
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 2},
                     "chunks": {"0": np.array([1.0, 2.0]), "1": np.array([3.0, 4.0])}}}
    out = msgpack_restore(serialization.msgpack_serialize(chunked))
    np.testing.assert_array_equal(out["w"], [[1.0, 2.0], [3.0, 4.0]])


def test_params_from_jax_loads_into_port_model():
    from twoforone_torch.models.graph_transformer import GraphTransformer

    params = load_ema_params("chain10")
    model = GraphTransformer(10, 64, 3, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False)
    sd = params_from_jax(params)
    model.load_state_dict(sd)  # strict: every key and shape must match
    np.testing.assert_array_equal(
        model.layers_1_attn.to_q.weight.detach().numpy(),
        params["layers_1_attn"]["to_q"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        model.layers_2_attn.edges_to_kv.weight.detach().numpy(),
        params["layers_2_attn"]["edges_to_kv_kernel"].T,
    )


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


# The port's reproduction workflows: they run on the card, which has no JAX.
WORKFLOW_SCRIPTS = (
    "_torch_workflow_common.py", "torch_evaluate_ala2.py", "torch_evaluate_fastfolders.py",
    "torch_paper_scale_langevin.py", "torch_chain10_control.py", "torch_langevin_t_sweep.py",
    "torch_ddim_quality.py", "torch_dynamics_analysis.py", "torch_positive_control.py",
    "torch_export_torch_checkpoint.py",
)


def test_port_imports_no_jax_flax_or_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files.append(os.path.join(REPO, "scripts", "torch_profile_langevin.py"))
    files += [os.path.join(REPO, "scripts", name) for name in WORKFLOW_SCRIPTS]
    assert len(files) > 15
    scanned = {os.path.relpath(f, PORT) for f in files}
    for module in ("cli/sample.py", "data/pdb.py", "data/datasets.py", "data/synthetic.py",
                   "data/molecules.py", "evaluate/deeptime_compat.py",
                   "evaluate/evaluators.py", "utils/config.py", "utils/convert.py",
                   "utils/artifacts.py", "models/__init__.py", "cli/train.py",
                   "train/trainer.py", "train/ema.py", "utils/preempt.py",
                   "utils/checkpoint.py", "evaluate/metrics.py", "evaluate/tica.py",
                   "evaluate/plots.py", "ops/geometry.py", "evaluate/kinetics.py",
                   "evaluate/ergodicity.py", "evaluate/__init__.py", "data/trajectory.py",
                   "dynamics/segmented.py", "utils/profiling.py", "utils/equivariance.py",
                   "train/positive_control.py", "parallel/mesh.py", "parallel/__init__.py"):
        assert module in scanned, module
    banned = ("jax", "flax", "twoforone_tpu", "optax")
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path} imports {mod}"


def _entry_points(tmp_path):
    import shutil

    from twoforone_torch.cli.sample import load_model
    from twoforone_torch.cli.sample import main as sample_cli
    from twoforone_torch.cli.train import main as train_cli
    from twoforone_torch.data.datasets import CGDataset
    from twoforone_torch.data.molecules import FOLDED_PDB_DIR
    from twoforone_torch.data.pdb import load_pdb
    from twoforone_torch.train.trainer import Trainer
    from twoforone_torch.utils.config import TrainConfig
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.dynamics.integrators import LangevinSimulation
    from twoforone_torch.dynamics.langevin import LangevinDiffusion, make_diffusion_force_fn
    from twoforone_torch.models.graph_transformer import GraphTransformer
    from twoforone_torch.ops.fused_score import make_fused_force_kernel
    from twoforone_torch.ops.fused_score_cl import augment_params_cl
    from twoforone_torch.ops.fused_score_clx import make_clx_force_fn

    model = GraphTransformer(5, 8, 1, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False,
                             heads=2, dim_head=4)
    gd = GaussianDiffusion(model=model, num_atoms=5, norm_factor=2.0)
    params = _model_params(model)
    init = np.zeros((2, 5, 3), np.float32)

    def force_fn(x):
        return torch.zeros(x.shape[0]), -x

    results = tmp_path / "chain10"
    shutil.copytree(trained_dir("chain10"), results)
    cli_args = ["--model_path", str(results), "--num_samples_eval", "2", "--batch_size_gen",
                "2", "--sample_steps", "2"]
    topology = load_pdb(os.path.join(FOLDED_PDB_DIR, "ala2_cg.pdb")).topology
    blobs = np.random.default_rng(0).normal(size=(3, 8, 5, 3)).astype(np.float32)
    datasets = tuple(CGDataset(b - b.mean(1, keepdims=True), topology, "alanine_fold1")
                     for b in blobs)
    train_cfg = TrainConfig(hidden_features_gnn=8, num_layers_gnn=1, data_folder=None,
                            results_folder=str(tmp_path / "trained"), batch_size=4)
    data = tmp_path / "ala2"
    data.mkdir()
    np.savez(data / "ala2_cg_2fs_Hmass_2_HBonds.npz", coords=blobs.reshape(-1, 5, 3))
    train_args = ["--data_folder", str(data), "--results_folder", str(tmp_path / "cli"),
                  "--tensorboard_folder", str(tmp_path / "runs"), "--hidden_features_gnn", "8",
                  "--num_layers_gnn", "1", "--batch_size", "4", "--train_iter", "1",
                  "--eval_interval", "10", "--num_samples_final_eval", "2",
                  "--diffusion_steps", "100", "--ala2_train_cap", "12"]

    return {
        "LangevinDiffusion": lambda **kw: LangevinDiffusion(
            gd, params, init, n_timesteps=10, save_interval=5, t=5,
            masses=[12.0] * 5, log=False, **kw),
        "make_diffusion_force_fn": lambda **kw: make_diffusion_force_fn(
            gd, params, 5, 1.0, **kw),
        "LangevinSimulation": lambda **kw: LangevinSimulation(
            force_fn=force_fn, initial_coordinates=init, length=10, save_interval=5, **kw),
        "augment_params_cl": lambda **kw: augment_params_cl(model, params, **kw),
        "make_clx_force_fn": lambda **kw: make_clx_force_fn(model, params, 0.1, **kw),
        "make_fused_force_kernel": lambda **kw: make_fused_force_kernel(
            model, params, 0.1, **kw),
        "GaussianDiffusion.sample": lambda **kw: gd.sample(
            params, 2, torch.Generator().manual_seed(0), sample_steps=2, **kw),
        "GaussianDiffusion.make_fused_sample_fn": lambda **kw: gd.make_fused_sample_fn(
            params, 2, sample_steps=2, **kw),
        "GaussianDiffusion.loss": lambda **kw: gd.loss(
            params, init, torch.Generator().manual_seed(0), **kw),
        "cli.sample.load_model": lambda **kw: load_model(str(results), "best", **kw),
        "cli.sample.main": lambda **kw: sample_cli(
            cli_args + [f"--{k}={v}" for k, v in kw.items()]),
        "Trainer": lambda **kw: Trainer(
            GaussianDiffusion(model=GraphTransformer(5, 8, 1), num_atoms=5), datasets,
            train_cfg.mol, train_cfg, use_tensorboard=False, evaluators=False, **kw),
        "cli.train.main": lambda **kw: train_cli(
            train_args + [f"--{k}={v}" for k, v in kw.items()]),
    }


def _model_params(model):
    """A flax-style parameter tree for ``model`` from its own random init."""
    tree = {}
    for key, val in model.state_dict().items():
        *mod, name = key.split(".")
        arr = val.numpy()
        if mod[-1] == "edges_to_kv":
            mod, name = mod[:-1], "edges_to_kv_" + ("kernel" if name == "weight" else "bias")
            arr = arr.T if name.endswith("kernel") else arr
        elif name == "weight" and "norm" in mod[-1]:
            name = "scale"
        elif name == "weight":
            name, arr = "kernel", arr.T
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = arr
    return tree


@pytest.mark.parametrize("name", ["LangevinDiffusion", "make_diffusion_force_fn",
                                  "LangevinSimulation", "augment_params_cl",
                                  "make_clx_force_fn", "make_fused_force_kernel",
                                  "GaussianDiffusion.sample",
                                  "GaussianDiffusion.make_fused_sample_fn",
                                  "GaussianDiffusion.loss", "cli.sample.load_model",
                                  "cli.sample.main", "Trainer", "cli.train.main"])
def test_entry_points_need_cuda_unless_cpu(name, monkeypatch, tmp_path):
    """Default device is CUDA: without it an entry point raises; with
    device="cpu" (the CLI: ``--device=cpu``) it runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    build(device="cpu")


@pytest.mark.parametrize("name", ["chain10", "ala5"])
def test_msgpack_writer_gives_flax_bytes(name):
    """A staged file (written by flax) read by the port and written back by
    the port's writer: the same bytes. And params_to_jax inverts
    params_from_jax on its weights, bit for bit."""
    from twoforone_torch.utils.checkpoint import msgpack_serialize
    from twoforone_torch.utils.convert import params_to_jax

    path = os.path.join(trained_dir(name), "model-best.msgpack")
    with open(path, "rb") as f:
        raw = f.read()
    assert msgpack_serialize(msgpack_restore(raw)) == raw
    tree = msgpack_restore(raw)["ema_params"]
    back = params_to_jax(params_from_jax(tree))
    assert dict(_leaves(back)).keys() == dict(_leaves(tree)).keys()
    for key, leaf in _leaves(tree):
        np.testing.assert_array_equal(dict(_leaves(back))[key], leaf)


def test_msgpack_writer_matches_flax_on_every_type(tmp_path):
    import jax

    from twoforone_torch.utils.checkpoint import (
        checkpoint_exists, load_checkpoint, msgpack_serialize, save_checkpoint)

    rng = np.random.default_rng(0)
    tree = {"step": 40, "best_val_loss": float("inf"), "neg": -5, "big": 2**40, "nb": -300,
            "s": "x" * 40, "b": {"k": rng.normal(size=(200, 70)).astype(np.float32)},
            "opt": {"0": {"count": np.asarray(7, np.int32), "mu": {}}, "1": {}},
            "sc": np.float32(2.5), "i64": np.int64(3), "l": [1, 2.0, None, True], "f": 0.1,
            "n": None, "ints": np.arange(5, dtype=np.int64), "d": np.zeros((0, 3))}
    ours = msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(jax.tree_util.tree_map(lambda x: x, tree))
    assert not checkpoint_exists(str(tmp_path), "last")
    save_checkpoint(str(tmp_path), "last", tree)
    assert checkpoint_exists(str(tmp_path), "last")
    assert os.listdir(tmp_path) == ["model-last.msgpack"]  # no temporary file left
    back = load_checkpoint(str(tmp_path), "last")
    assert back["step"] == 40 and back["best_val_loss"] == float("inf")
    np.testing.assert_array_equal(back["b"]["k"], tree["b"]["k"])
    with pytest.raises(TypeError):
        msgpack_serialize({"x": object()})
