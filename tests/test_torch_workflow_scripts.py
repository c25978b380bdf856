"""The port's workflow scripts (``scripts/torch_*.py``) against the JAX
scripts, on the CPU.

- The shared rebuild (``scripts/_torch_workflow_common.py``) gives the JAX
  scripts' norm factors exactly (numpy on the same synthetic trajectory) and
  their energies on the staged chain10 and chain20 within 2e-5 of the
  largest (float32 reduction order, as the model's parity tests).
- The staging gate of ``torch_chain10_control.py`` refuses failing results
  unless given ``--force_stage``, writes only under ``--stage_dir``, and
  the staged checkpoint loads in the JAX package's ``load_checkpoint``.
- The exported ``.pt`` and ``args.pickle`` equal the JAX script's exactly.
- The t-sweep, the quality ladder, the dynamics analysis and the positive
  control run at tiny sizes with their JAX scripts' keys (read from the JAX
  sources); the dynamics analysis equals the JAX script's on the same
  trajectory.
- A script that runs a model raises without CUDA unless given
  ``--device cpu``.

Every run here is held to leave ``twoforone_tpu/`` and ``docs/`` byte for
byte as they were (:func:`unchanged_jax_tree`).
"""

import ast
import contextlib
import hashlib
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from chip_smoke import CHAIN_CONTROL_KEYS
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TOL_ENERGY_REL = 2e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def script_module(name):
    """``scripts/<name>.py`` as a module (its ``main`` takes ``argv``)."""
    if name not in sys.modules:
        if SCRIPTS not in sys.path:
            sys.path.insert(0, SCRIPTS)
        sys.modules[name] = _load(name, os.path.join(SCRIPTS, f"{name}.py"))
    return sys.modules[name]


def jax_script_module(name, tmp_path=None):
    """The JAX script ``scripts/<name>.py`` as a fresh module. With
    ``tmp_path`` its ``REPO`` / ``_REPO`` point there (with the JAX package
    linked in), so that what it writes beside the repository lands there."""
    module = _load(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    if tmp_path is not None:
        link = os.path.join(tmp_path, "twoforone_tpu")
        if not os.path.exists(link):
            os.symlink(os.path.join(REPO, "twoforone_tpu"), link)
        for attr in ("REPO", "_REPO"):
            if hasattr(module, attr):
                setattr(module, attr, str(tmp_path))
    return module


def _tree_digest():
    digest = {}
    for top in ("twoforone_tpu", "docs"):
        for folder, dirs, files in os.walk(os.path.join(REPO, top)):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                path = os.path.join(folder, name)
                with open(path, "rb") as f:
                    digest[os.path.relpath(path, REPO)] = hashlib.sha1(f.read()).hexdigest()
    return digest


@contextlib.contextmanager
def unchanged_jax_tree():
    """Hold ``twoforone_tpu/`` and ``docs/`` byte for byte unchanged (no file
    added, removed or rewritten; byte code aside) across the block."""
    before = _tree_digest()
    yield
    after = _tree_digest()
    assert after == before, sorted(set(after.items()) ^ set(before.items()))[:10]


def _dict_keys(path, func, var):
    """The keys a JAX script's ``func`` writes into the dict ``var``:
    literal keys and ``var[...] = ...`` targets; an f-string key is rendered
    with ``{}`` for each of its fields."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)

    def render(node):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(v.value if isinstance(v, ast.Constant) else "{}" for v in node.values)

    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name) and tgt.id == var
                        and isinstance(node.value, ast.Dict)):
                    keys.update(render(k) for k in node.value.keys if k is not None)
                elif (isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name)
                      and tgt.value.id == var):
                    keys.add(render(tgt.slice))
    return keys


# ----------------------------------------------------------------- rebuild
@pytest.mark.parametrize("n_beads", [10, 20])
def test_rebuild_matches_jax_scripts(n_beads, tmp_path):
    """chain10: paper_scale_langevin.build_chain10 (the std of the
    mean-centred train split); chain20: ddim_quality.rebuild_control
    (``traj[:280000].std()``). Norm factors exactly, energies within 2e-5
    of the largest."""
    import jax.numpy as jnp

    from twoforone_tpu.models.graph_transformer import score_forward as jscore
    from twoforone_torch.models.graph_transformer import score_forward

    common = script_module("_torch_workflow_common")
    with unchanged_jax_tree():
        if n_beads == 10:
            jgd, jparams = jax_script_module("paper_scale_langevin", tmp_path).build_chain10()
            norm = common.dataset_norm_factor(10)
        else:
            jgd, jparams, _ = jax_script_module("ddim_quality").rebuild_control(20)
            norm = common.split_norm_factor(20)
        gd, params, comp = common.rebuild_control(n_beads, norm)
    assert norm == float(jgd.norm_factor)
    assert len(comp) == n_beads - 3
    x = np.random.default_rng(n_beads).normal(size=(4, n_beads, 3)).astype(np.float32)
    t = np.full((4,), 0.02, np.float32)
    ref = np.asarray(jscore(jgd.model, jparams, jnp.asarray(x), jnp.asarray(t),
                            return_energy=True))
    with torch.no_grad():
        out = score_forward(gd.model, torch.from_numpy(x), torch.from_numpy(t),
                            return_energy=True).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL_ENERGY_REL * np.abs(ref).max(), rtol=0)


# ------------------------------------------------------------ staging gate
def test_staging_gate_and_stage_dir(tmp_path, monkeypatch, capsys):
    """A tiny chain control through the script: the bars fail, so nothing is
    staged; with --force_stage the three files land in --stage_dir alone,
    and the JAX package's load_checkpoint reads the staged checkpoint."""
    import twoforone_torch.train.positive_control as pc
    from twoforone_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from twoforone_torch.utils.checkpoint import read_checkpoint

    real = pc.run_chain_control
    tiny = dict(train_iter=50, n_data=2000, batch_size=64, hidden_nf=16, n_layers=1,
                num_samples=64, langevin_chains=8, langevin_steps=200,
                langevin_save_interval=50, timesteps=100, eval_samples=2000)
    seen = []

    def tiny_control(**kwargs):
        seen.append(dict(kwargs))
        return real(**{**kwargs, **tiny})

    monkeypatch.setattr(pc, "run_chain_control", tiny_control)
    main = script_module("torch_chain10_control").main
    results_folder, stage = tmp_path / "run", tmp_path / "staged"
    args = ["--results_folder", str(results_folder), "--stage_dir", str(stage),
            "--device", "cpu", "--eval_interval", "50"]
    with unchanged_jax_tree():
        refused = main(args)
        assert "physics bars FAILED" in capsys.readouterr().out
        assert not pc.physics_bars_ok(refused) and not stage.exists()
        forced = main([*args, "--force_stage", "--resume"])
    assert seen[0] == dict(n_beads=10, fused="auto", eval_interval=50, resume=False,
                           device="cpu", results_folder=str(results_folder))
    assert seen[1]["resume"] is True
    assert sorted(os.listdir(stage)) == ["config.json", "model-best.msgpack", "results.json"]
    with open(stage / "results.json") as f:
        assert json.load(f) == forced
    assert set(forced) == set(CHAIN_CONTROL_KEYS) | {"wall_s"}
    jax_state = jax_load_checkpoint(str(stage), "best", None)
    ours = read_checkpoint(str(stage / "model-best.msgpack"))
    assert jax_state["step"] == ours["step"] == 50
    flat = {}

    def walk(a, b, prefix=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), prefix
            for k in a:
                walk(a[k], b[k], f"{prefix}/{k}")
        else:
            flat[prefix] = True
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=prefix)

    walk(jax_state["ema_params"], ours["ema_params"])
    assert len(flat) > 10


# ------------------------------------------------------------------ export
def test_export_equals_jax_script(tmp_path, monkeypatch):
    import shutil

    model_path = tmp_path / "chain10"
    shutil.copytree(os.path.join(REPO, "twoforone_tpu", "assets", "trained", "chain10"),
                    model_path)
    with unchanged_jax_tree():
        script_module("torch_export_torch_checkpoint").main(
            ["--model_path", str(model_path), "--out", str(tmp_path / "port")])
        monkeypatch.setattr(sys, "argv", ["export_torch_checkpoint.py", "--model_path",
                                          str(model_path), "--out", str(tmp_path / "jax")])
        jax_script_module("export_torch_checkpoint").main()
    ours = torch.load(tmp_path / "port" / "model-best.pt")["ema"]
    ref = torch.load(tmp_path / "jax" / "model-best.pt")["ema"]
    assert list(ours) == list(ref) and len(ref) == 148
    for key, tensor in ref.items():
        assert ours[key].dtype == tensor.dtype and ours[key].shape == tensor.shape, key
        assert torch.equal(ours[key], tensor), key
    with open(tmp_path / "port" / "args.pickle", "rb") as f:
        ns_ours = pickle.load(f)
    with open(tmp_path / "jax" / "args.pickle", "rb") as f:
        ns_ref = pickle.load(f)
    assert vars(ns_ours) == vars(ns_ref)


# -------------------------------------------------------- tiny workflows
@pytest.fixture(scope="module")
def chain10_init(tmp_path_factory):
    """Equilibrium draws of the chain10 system, the sweep's initial chains."""
    from twoforone_torch.data.synthetic import chain_dataset
    from twoforone_torch.train.positive_control import chain_control_components

    path = tmp_path_factory.mktemp("init") / "init10.npy"
    np.save(path, chain_dataset(64, chain_control_components(10), seed=5).astype(np.float32))
    return str(path)


def test_t_sweep_and_dynamics_analysis(chain10_init, tmp_path):
    """The sweep at two t values (its JAX script's keys, the chain's frames
    saved), then the dynamics analysis of the saved trajectory: the same
    JSON as the JAX script's on it, and the default output outside docs/."""
    traj = str(tmp_path / "traj.npy")
    with unchanged_jax_tree():
        results, rates = script_module("torch_langevin_t_sweep").main(
            ["--n_beads", "10", "--init", chain10_init, "--t", "5", "20", "--chains", "4",
             "--steps", "200", "--save_interval", "10", "--eval_samples", "2000",
             "--save_traj", traj, "--out", str(tmp_path / "sweep.json"), "--device", "cpu"])
    want = _dict_keys(os.path.join(SCRIPTS, "langevin_t_sweep.py"), "main", "results")
    assert set(results) == want
    assert set(results["t"]) == {5, 20} and set(rates) == {5, 20}
    for entry in results["t"].values():
        assert set(entry) == {"tic_js", "nonfinite_frac"} and entry["nonfinite_frac"] == 0.0
    with open(tmp_path / "sweep.json") as f:
        assert json.load(f)["t"].keys() == {"5", "20"}
    assert np.load(traj).shape == (4 * 20, 10, 3)

    args = ["--n_beads", "10", "--chains", "4", "--traj", traj, "--n_clusters", "3",
            "--ref_frames", "20000"]
    port_mod = script_module("torch_dynamics_analysis")
    jax_mod = jax_script_module("dynamics_analysis", tmp_path)
    os.makedirs(tmp_path / "docs")
    with unchanged_jax_tree():
        ours = port_mod.main(args)
        sys_argv = sys.argv
        sys.argv = ["dynamics_analysis.py", *args]
        try:
            jax_mod.main()
        finally:
            sys.argv = sys_argv
    default = os.path.join(REPO, ".controls", "torch_dynamics_chain10.json")
    with open(default) as f:
        written = json.load(f)
    os.remove(default)
    with open(tmp_path / "docs" / "dynamics_chain10.json") as f:
        ref = json.load(f)
    ref["trajectory"] = os.path.relpath(traj, REPO)  # the JAX one is relative to tmp_path
    assert written == ours == ref


def test_ddim_quality_ladder(tmp_path):
    with unchanged_jax_tree():
        results = script_module("torch_ddim_quality").main(
            ["--n_beads", "10", "--steps", "5", "2", "--num_samples", "8", "--batch", "8",
             "--out", str(tmp_path / "q.json"), "--device", "cpu"])
    templates = _dict_keys(os.path.join(SCRIPTS, "ddim_quality.py"), "main", "results")
    want = {k.format(s) for k in templates for s in (5, 2)}
    assert set(results) == want
    with open(tmp_path / "q.json") as f:
        assert json.load(f) == results
    assert all(np.isfinite(v) for k, v in results.items() if k not in ("solver", "bf16"))


def _call_keywords(path, func):
    """Keyword arguments with constant values of the call of ``func`` in a
    JAX script."""
    with open(path) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == func)
    return {k.arg: k.value.value for k in call.keywords if isinstance(k.value, ast.Constant)}


def test_positive_control_script(capsys, monkeypatch):
    """The script hands run_positive_control the JAX script's recipe (the
    run itself at a tiny size: 1000-step reverse chains at batch 1024 take
    minutes on the host) and prints the JAX function's keys."""
    import twoforone_torch.train.positive_control as pc
    from test_torch_positive_control import _jax_result_keys

    real, seen = pc.run_positive_control, []

    def tiny_control(**kwargs):
        seen.append(dict(kwargs))
        return real(**{**kwargs, **dict(
            n_data=2000, batch_size=64, hidden_nf=16, n_layers=1, langevin_chains=4,
            langevin_steps=100, timesteps=100, final_eval_samples=8)})

    monkeypatch.setattr(pc, "run_positive_control", tiny_control)
    with unchanged_jax_tree():
        results = script_module("torch_positive_control").main(
            ["2", "8", "--no_plots", "--device", "cpu"])
    recipe = _call_keywords(os.path.join(SCRIPTS, "positive_control.py"),
                            "run_positive_control")
    assert seen == [dict(recipe, train_iter=2, num_samples=8, device="cpu", evaluators=False)]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(results) == _jax_result_keys("run_positive_control")


# ------------------------------------------------------------- device rule
DEVICE_RUNS = {
    "torch_chain10_control": [],
    "torch_langevin_t_sweep": ["--init", "unused.npy"],
    "torch_ddim_quality": [],
    "torch_positive_control": ["--no_plots"],
}


@pytest.mark.parametrize("script", sorted(DEVICE_RUNS))
def test_scripts_need_cuda_unless_cpu(script, monkeypatch):
    """Without CUDA a script that runs a model raises before any work,
    rather than falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script_module(script).main(DEVICE_RUNS[script])


def test_chip_smoke_keys_are_the_jax_scripts():
    """phase 15 of chip_smoke.py (the card has no JAX) holds the scripts'
    products to these key sets; here they are held to the JAX scripts'."""
    import chip_smoke as cs

    def keys(script, func, var):
        return _dict_keys(os.path.join(SCRIPTS, script), func, var)

    assert set(cs.PAPER_RESULT_KEYS) == keys("paper_scale_langevin.py", "main", "results")
    assert set(cs.FASTFOLDER_KEYS) == keys("evaluate_fastfolders.py", "main", "results") - {
        "transition_matrix", "state_counts"}
    assert set(cs.ALA2_KEYS) == keys("evaluate_ala2.py", "main", "results")
    assert set(cs.SWEEP_KEYS) == keys("langevin_t_sweep.py", "main", "results")
    assert set(cs.QUALITY_KEYS) == {k.format(s) for k in keys("ddim_quality.py", "main",
                                                                "results")
                                    for s in cs.QUALITY_STEPS}
