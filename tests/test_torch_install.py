"""The port as an installed package, on the CPU.

- Every kernel source and header under ``twoforone_torch/ops/csrc`` is
  package data (``pyproject.toml``), so an installed copy can compile its
  kernels.
- A wheel built by pip from a copy of ``pyproject.toml`` and the two
  packages (without the staged weights; ``chip_smoke.build_wheel``, which
  phase 14 runs on the card) ships them and the port's console scripts; unpacked into a directory of its own, its entry points load from
  there, and ``tfo-torch-sample`` called as its wrapper calls it runs on the
  host, exits 0, writes nothing inside the installed package and gives the
  in-tree CLI's samples bit for bit.
- ``ops/_build.py::build_dir`` follows its rule: ``$TFO_KERNEL_CACHE``, else
  the package's ``_build/`` when it can be written, else
  ``$XDG_CACHE_HOME/twoforone_torch_kernels`` (``~/.cache`` by default);
  the libraries follow it, and a directory that cannot be made is an error.
- Importing every module of the port compiles nothing and touches no card.
"""

import fnmatch
import json
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile

import numpy as np
import pytest

import chip_smoke
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.cli import sample as cli
from twoforone_torch.ops import _build
from twoforone_torch.utils.artifacts import trained_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = sorted(os.listdir(os.path.join(REPO, "twoforone_torch", "ops", "csrc")))
SCRIPTS = chip_smoke.CONSOLE_SCRIPTS
TINY_RUN = ["--gen_mode", "langevin", "--device", "cpu", "--parallel_sim", "4",
            "--batch_size_gen", "4", "--n_timesteps", "20", "--save_interval", "10",
            "--sample_steps", "3"]


def test_csrc_holds_the_kernel_sources_and_header():
    assert {"fused_score_cl.cu", "fused_score.cu", "attention_cl_core.cu",
            "tile_gemm.cuh"} <= set(CSRC)


@pytest.mark.parametrize("name", CSRC)
def test_every_kernel_source_is_package_data(name):
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["twoforone_torch"]
    assert any(fnmatch.fnmatch(f"ops/csrc/{name}", g) for g in globs), globs


def installed_env(site, **extra):
    """An environment whose Python finds the port in ``site`` alone: no byte
    code written, one torch thread."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=site, PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel of the tree, built by pip without an index, and its
    unpacked copy: (wheel path, member names, entry_points.txt, site)."""
    tmp = tmp_path_factory.mktemp("wheel")
    path, _ = chip_smoke.build_wheel(str(tmp))
    site = str(tmp / "installed")
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        (eps,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        entry_points = z.read(eps).decode()
        z.extractall(site)
    return path, names, entry_points, site


def test_wheel_ships_every_kernel_source_and_no_build(wheel):
    _, names, _, _ = wheel
    for name in CSRC:
        assert f"twoforone_torch/ops/csrc/{name}" in names
    assert not any("/_build/" in n or n.endswith(".so") for n in names)
    assert not any("/assets/trained/" in n for n in names)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_wheel_console_script_loads_from_the_installed_copy(wheel, script, tmp_path):
    """The entry point is in the wheel's entry_points.txt and, with the
    unpacked wheel as the only place the port can come from, resolves to a
    callable of the installed copy."""
    _, _, entry_points, site = wheel
    assert f"{script} = {SCRIPTS[script]}" in entry_points
    code = ("import json, sys; from importlib.metadata import entry_points; "
            f"(ep,) = entry_points(group='console_scripts', name={script!r}); f = ep.load(); "
            "print(json.dumps([ep.value, callable(f), sys.modules[f.__module__].__file__, "
            "str(ep.dist.locate_file(''))]))")
    proc = subprocess.run([sys.executable, "-P", "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env=installed_env(site), timeout=120)
    assert proc.returncode == 0, proc.stderr
    value, is_callable, module_file, dist_root = json.loads(proc.stdout.splitlines()[-1])
    assert value == SCRIPTS[script] and is_callable
    assert os.path.realpath(module_file).startswith(os.path.realpath(site) + os.sep)
    assert os.path.realpath(dist_root) == os.path.realpath(site)


def test_installed_sample_script_runs_on_the_host(wheel, tmp_path):
    """``tfo-torch-sample`` from the unpacked wheel, called as the console
    script's wrapper does (``sys.exit(f())``): exit 0, the JAX CLI's files,
    the in-tree CLI's samples bit for bit, nothing compiled or written inside
    the installed package."""
    _, _, _, site = wheel
    installed, in_tree = tmp_path / "installed_run", tmp_path / "in_tree_run"
    for folder in (installed, in_tree):
        shutil.copytree(trained_dir("chain10"), folder)
    work, cache = tmp_path / "work", tmp_path / "kernel_cache"
    work.mkdir()
    before = chip_smoke.tree_state(os.path.join(site, "twoforone_torch"))
    code = ("import sys; from importlib.metadata import entry_points; "
            "(ep,) = entry_points(group='console_scripts', name='tfo-torch-sample'); "
            "sys.argv = ['tfo-torch-sample', *sys.argv[1:]]; sys.exit(ep.load()())")
    proc = subprocess.run(
        [sys.executable, "-P", "-c", code, "--model_path", str(installed), *TINY_RUN],
        cwd=work, capture_output=True, text=True, timeout=300,
        env=installed_env(site, TFO_KERNEL_CACHE=str(cache)))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert chip_smoke.tree_state(os.path.join(site, "twoforone_torch")) == before
    assert not cache.exists() and os.listdir(work) == []
    written = installed / "main_eval_output_langevin" / "sample-langevin"
    out = np.load(f"{written}.npy")
    assert out.shape == (8, 10, 3) and np.isfinite(out).all()
    assert os.path.exists(f"{written}.pt") and os.path.exists(f"{written}.pdb")
    ref = cli.main(["--model_path", str(in_tree), *TINY_RUN])
    assert out.dtype == ref.dtype and out.tobytes() == ref.tobytes()


def test_console_main_returns_zero(monkeypatch):
    """The wrapper of a console script exits with what its function returns:
    ``main`` returns the samples (or the trainer), which ``sys.exit`` would
    print and read as a failure, so the scripts call ``console_main``."""
    from twoforone_torch.cli import train

    seen = []
    for module in (cli, train):
        monkeypatch.setattr(module, "main", lambda argv=None: seen.append(argv) or object())
        assert module.console_main() == 0
    assert seen == [None, None]


def test_build_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("TFO_KERNEL_CACHE", str(tmp_path / "cache"))
    assert _build.build_dir() == str(tmp_path / "cache")
    path = _build.library_path("fused_score_cl")
    assert os.path.dirname(path) == str(tmp_path / "cache")
    monkeypatch.setenv("TFO_KERNEL_CACHE", str(tmp_path / "other"))
    moved = _build.library_path("fused_score_cl")
    assert os.path.dirname(moved) == str(tmp_path / "other")
    assert os.path.basename(moved) == os.path.basename(path)


def test_build_dir_is_the_package_dir_where_it_can_be_written(monkeypatch, tmp_path):
    assert _build.PACKAGE_BUILD_DIR == os.path.join(REPO, "twoforone_torch", "_build")
    monkeypatch.delenv("TFO_KERNEL_CACHE", raising=False)
    package = tmp_path / "twoforone_torch" / "_build"
    monkeypatch.setattr(_build, "PACKAGE_BUILD_DIR", str(package))
    assert _build.build_dir() == str(package) and package.is_dir()
    assert os.listdir(package) == []  # the probe leaves nothing behind
    assert os.path.dirname(_build.library_path("attention_cl_core")) == str(package)


@pytest.mark.parametrize("xdg", [True, False])
def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path, xdg):
    """An installed package that cannot be written (stood in for: root
    ignores mode bits) builds into the user's cache directory."""
    monkeypatch.delenv("TFO_KERNEL_CACHE", raising=False)
    package = _build.PACKAGE_BUILD_DIR
    probe = _build.writable
    monkeypatch.setattr(_build, "writable", lambda path: path != package and probe(path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "twoforone_torch_kernels"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        want = tmp_path / "home" / ".cache" / "twoforone_torch_kernels"
    assert _build.build_dir() == str(want)
    assert os.path.dirname(_build.library_path("fused_score")) == str(want)


def test_writable_is_found_by_trying(tmp_path):
    assert _build.writable(str(tmp_path / "a" / "b"))
    assert os.listdir(tmp_path / "a" / "b") == []
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert not _build.writable(str(blocker / "build"))


def test_unwritable_kernel_cache_fails_the_build(monkeypatch, tmp_path):
    """No fallback hides it: a build directory that cannot be made raises."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("TFO_KERNEL_CACHE", str(blocker / "cache"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(OSError):
        _build.load("fused_score_cl")


def test_importing_the_port_compiles_nothing(tmp_path):
    """Every module of the port imported in a fresh process, with no nvcc on
    the path: nothing compiled or loaded, no build directory made, CUDA not
    initialized."""
    port = os.path.join(REPO, "twoforone_torch")
    modules = sorted(
        os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__")
        for d, _, fs in os.walk(port) for f in fs if f.endswith(".py"))
    assert len(modules) > 50
    code = ("import importlib, json, sys, torch; "
            "[importlib.import_module(m) for m in sys.argv[1:]]; "
            "from twoforone_torch.ops import _build; "
            "print(json.dumps([_build.logs, list(_build._loaded), "
            "torch.cuda.is_initialized(), 'jax' in sys.modules, "
            "'twoforone_tpu' in sys.modules]))")
    env = dict(os.environ, PATH="/usr/bin:/bin", TFO_KERNEL_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, *modules], cwd=tmp_path,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == [{}, [], False, False, False]
    assert not (tmp_path / "cache").exists()
