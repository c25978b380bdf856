"""The port's evaluation scripts (``scripts/torch_evaluate_ala2.py``,
``scripts/torch_evaluate_fastfolders.py``) against the JAX scripts on the
same seeded sample files, on the CPU.

The JAX script runs as a user runs it, in a process of its own with
``JAX_PLATFORMS=cpu``; the port's script through its ``main`` here (it
imports no JAX). Tolerances, from CPU-against-CPU runs of the two: the
histogram metrics (dihedral JS, KL, free-energy MSE; PWD JS, TIC JS; the
contact BCE) read float32 features in both packages and came out equal, so
they are held within 1e-9; the RMSD mean sums float32 Kabsch RMSDs (jnp
against torch SVD), 2e-8 apart, held within 1e-6 relative; the transition
matrix and the state counts exactly (k-means on the same TIC coordinates).

Also: ``--no_plots`` writes no figure and the same numbers, and without
matplotlib a script stops with an error that names ``--no_plots`` unless it
is given.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from test_torch_workflow_scripts import script_module, unchanged_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_HIST = 1e-9
TOL_RMSD_REL = 1e-6
# Imports the script with matplotlib unimportable, then runs its main.
WITHOUT_MATPLOTLIB = """
import runpy, sys
sys.modules["matplotlib"] = None
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
"""


def _jax_script(script, args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *args],
                         capture_output=True, text=True, timeout=600, env=env, cwd=cwd)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.fixture(scope="module")
def sample_files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("samples")
    rng = np.random.default_rng(0)
    np.save(folder / "ala2.npy", (rng.normal(size=(400, 5, 3)) * 0.9).astype(np.float32))
    rng = np.random.default_rng(1)
    # 4 chains x 100 frames of chignolin-scale coordinates (std ~3 A)
    np.save(folder / "chignolin.npy", (rng.normal(size=(400, 10, 3)) * 3.1).astype(np.float32))
    return folder


def _close(port, jax_res):
    assert port.keys() == jax_res.keys()
    for key, ref in jax_res.items():
        got = port[key]
        if key == "RMSD mean (A)":
            assert abs(got - ref) <= TOL_RMSD_REL * abs(ref), key
        elif isinstance(ref, list):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=key)
        else:
            assert np.isfinite(got) and abs(got - ref) <= TOL_HIST, (key, got, ref)


def test_evaluate_ala2_matches_jax_script(sample_files, tmp_path):
    samples = str(sample_files / "ala2.npy")
    with unchanged_jax_tree():
        _jax_script("evaluate_ala2.py", ["--samples", samples, "--out", "jax"], tmp_path)
        port = script_module("torch_evaluate_ala2").main(
            ["--samples", samples, "--out", str(tmp_path / "port")])
    with open(tmp_path / "jax" / "results_ala2.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "results_ala2.json") as f:
        assert json.load(f) == port
    _close(port, ref)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_evaluate_fastfolders_trajectory_matches_jax_script(sample_files, tmp_path):
    samples = str(sample_files / "chignolin.npy")
    args = ["--mol", "chignolin", "--samples", samples, "--trajectory", "--n-sims", "4",
            "--n-clusters", "3"]
    with unchanged_jax_tree():
        _jax_script("evaluate_fastfolders.py", [*args, "--out", "jax"], tmp_path)
        port = script_module("torch_evaluate_fastfolders").main(
            [*args, "--out", str(tmp_path / "port")])
    with open(tmp_path / "jax" / "results_chignolin.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "results_chignolin.json") as f:
        assert json.load(f) == port
    assert np.asarray(ref["transition_matrix"]).shape == (3, 3)
    _close(port, ref)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("script,args,result", [
    ("torch_evaluate_ala2", [], "results_ala2.json"),
    ("torch_evaluate_fastfolders", ["--mol", "chignolin"], "results_chignolin.json"),
])
def test_no_plots_draws_nothing_and_scores_the_same(script, args, result, sample_files,
                                                    tmp_path):
    samples = str(sample_files / ("ala2.npy" if "ala2" in script else "chignolin.npy"))
    main = script_module(script).main
    with unchanged_jax_tree():
        plotted = main([*args, "--samples", samples, "--out", str(tmp_path / "plots")])
        bare = main([*args, "--samples", samples, "--out", str(tmp_path / "bare"),
                     "--no_plots"])
    assert bare == plotted
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "plots"))
    assert os.listdir(tmp_path / "bare") == [result]


@pytest.mark.parametrize("script,args", [
    ("torch_evaluate_ala2.py", []),
    ("torch_evaluate_fastfolders.py", ["--mol", "chignolin"]),
])
def test_without_matplotlib_stops_unless_no_plots(script, args, sample_files, tmp_path):
    samples = str(sample_files / ("ala2.npy" if "ala2" in script else "chignolin.npy"))
    cmd = [sys.executable, "-c", WITHOUT_MATPLOTLIB, os.path.join(REPO, "scripts", script),
           *args, "--samples", samples]
    stopped = subprocess.run([*cmd, "--out", str(tmp_path / "stopped")], capture_output=True,
                             text=True, timeout=300)
    assert stopped.returncode != 0
    assert "matplotlib is not installed" in stopped.stderr
    assert "--no_plots" in stopped.stderr
    assert not os.path.exists(tmp_path / "stopped")
    bare = subprocess.run([*cmd, "--out", str(tmp_path / "bare"), "--no_plots"],
                          capture_output=True, text=True, timeout=300)
    assert bare.returncode == 0, bare.stderr[-3000:]
    (result,) = os.listdir(tmp_path / "bare")
    with open(tmp_path / "bare" / result) as f:
        assert all(np.isfinite(v) for v in json.load(f).values())
