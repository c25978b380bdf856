"""Port's sampling CLI against the JAX package's, on temporary copies of the
staged results directories (the CLI writes into ``--model_path``).

- Settings: both CLIs' ``main`` run with their ``LangevinDiffusion`` and
  ``sample_from_model`` replaced by recorders (the JAX CLI imports them
  inside ``main``, so patching the module attributes reaches it). What each
  resolved must be equal.
- Samples: Langevin under a numpy initial state and numpy noise against the
  JAX BAOAB loop at the settings the JAX CLI resolved; i.i.d. DDIM with the
  noise the JAX CLI draws rebuilt from its key splits against the JAX CLI's
  own output.

The JAX CLI's loader builds its parameter template with ``init_params``,
eagerly (~6 s a model on the CPU); the tests give it the template from
``jax.eval_shape`` of the same call, which has the same tree and no values,
so the weights it restores are the same.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import twoforone_tpu.cli.sample as jcli
import twoforone_tpu.core.diffusion as jdiff
import twoforone_tpu.dynamics.langevin as jlang
import twoforone_tpu.evaluate.evaluators as jeval
import twoforone_tpu.utils.cache as jcache
from twoforone_tpu.dynamics import integrators as jint
from twoforone_tpu.ops.geometry import center_zero as jcenter
from twoforone_torch.cli import sample as tcli
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.data.pdb import load_pdb
from twoforone_torch.models.graph_transformer import GraphTransformer
from twoforone_torch.utils.artifacts import trained_dir

from test_torch_checkpoint import _leaves

STAGED = {"ala5": 5, "chain10": 10, "chain20": 20, "chain28": 28, "chain35": 35, "chain56": 56}
CHAINS = 8  # a multiple of the test mesh's 8 devices: the JAX CLI pads nothing


@pytest.fixture(autouse=True)
def _quick_jax_cli(monkeypatch):
    """The JAX CLI without the eager template build and without pointing the
    compilation cache elsewhere than the tests' own."""
    def template(self, key):
        return jax.eval_shape(lambda: self.model.init(
            key, jnp.zeros((1, self.num_atoms, 3)), jnp.zeros((1,)),
            **({"return_energy": True} if self.model.conservative else {}))["params"])

    monkeypatch.setattr(jdiff.GaussianDiffusion, "init_params", template)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)


def _copy(name, tmp_path, side=""):
    dst = tmp_path / side / name
    shutil.copytree(trained_dir(name), dst)
    return str(dst)


def _record(monkeypatch, package, ld_class, cli_module, eval_module):
    """Replace a package's LangevinDiffusion (constructed for real, sample()
    returns zeros) and sample_from_model (returns zeros) by recorders."""
    seen = {}

    class Recorder(ld_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["ld"], seen["ld_kwargs"] = self, kwargs
            seen["gd"], seen["params"], seen["init"] = args

        def sample(self, reference_temp=None):
            seen["reference_temp"] = reference_temp
            sim = self.sim
            return np.zeros((sim.n_sims * sim.length // sim.save_interval, sim.n_beads, 3),
                            np.float32)

    def sample_from_model(sample_fn, num, batch_size, *args, **kwargs):
        seen.setdefault("sample_calls", []).append((num, batch_size))
        if hasattr(sample_fn, "kernel"):  # the port's driver names it
            seen["sampler_kernel"] = sample_fn.kernel
        return np.zeros((num, seen["num_atoms"], 3), np.float32)

    target = jlang if package == "jax" else cli_module
    monkeypatch.setattr(target, "LangevinDiffusion", Recorder)
    monkeypatch.setattr(eval_module if package == "jax" else cli_module,
                        "sample_from_model", sample_from_model)
    return seen


def _jax_sampler_kernels(monkeypatch, seen):
    """Record the kernel the JAX CLI hands its sampler: ``make_sample_fn`` is
    the plain network ("xla"), ``make_fused_sample_fn`` names its kernel."""
    def plain(self, batch_size, **kw):
        seen["sampler_kernel"] = "xla"
        return lambda params, key: None

    def fused(self, params, batch_size, kernel="auto", **kw):
        seen["sampler_kernel"] = kernel
        return lambda key: None

    monkeypatch.setattr(jdiff.GaussianDiffusion, "make_sample_fn", plain)
    monkeypatch.setattr(jdiff.GaussianDiffusion, "make_fused_sample_fn", fused)


def _run_both(name, args, tmp_path, monkeypatch):
    path = _copy(name, tmp_path)
    argv = ["--model_path", path, "--parallel_sim", str(CHAINS),
            "--batch_size_gen", str(CHAINS), "--num_samples_eval", "12", *args]
    out = {}
    with monkeypatch.context() as m:
        seen = _record(m, "jax", jlang.LangevinDiffusion, jcli, jeval)
        seen["num_atoms"] = STAGED[name]
        _jax_sampler_kernels(m, seen)
        jcli.main(argv)
        out["jax"] = seen
    with monkeypatch.context() as m:
        seen = _record(m, "torch", tcli.LangevinDiffusion, tcli, None)
        seen["num_atoms"] = STAGED[name]
        tcli.main(argv + ["--device", "cpu"])
        out["torch"] = seen
    return path, out["jax"], out["torch"]


CASES = {
    "langevin": ["--gen_mode", "langevin", "--n_timesteps", "20", "--save_interval", "10"],
    "langevin_auto_tempering": ["--gen_mode", "langevin", "--n_timesteps", "20",
                                "--save_interval", "5", "--fused", "auto", "--tempering",
                                "--noise_level", "12", "--kb", "kcal",
                                "--append_exp_name", "ramp"],
    "iid_auto": ["--gen_mode", "iid", "--fused", "auto", "--sample_steps", "4"],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(STAGED))
def test_cli_resolves_the_jax_settings(name, case, tmp_path, monkeypatch):
    """Every staged artifact: the force path and sampler kernel resolved on
    the CPU, dt after dt_scale, masses, temperatures, kb, t, norm_factor, the
    number of frames saved, the tempering reference temperature and the
    output folder are the JAX CLI's."""
    path, jax_seen, ours = _run_both(name, CASES[case], tmp_path, monkeypatch)
    assert ours["sampler_kernel"] == jax_seen["sampler_kernel"] == "xla"
    assert ours["sample_calls"] == jax_seen["sample_calls"]
    mode = CASES[case][1]
    folder = f"main_eval_output_{mode}" + ("_ramp" if "ramp" in CASES[case] else "")
    assert sorted(os.listdir(path)) == sorted(
        os.listdir(trained_dir(name)) + [folder])
    written = np.load(os.path.join(path, folder, f"sample-{mode}.npy"))
    if mode == "iid":
        assert written.shape == (12, STAGED[name], 3)
        return
    ld, jld = ours["ld"], jax_seen["ld"]
    kw, jkw = ours["ld_kwargs"], jax_seen["ld_kwargs"]
    for key in ("t", "temp_data", "temp_sim", "kb", "masses", "dt", "dt_scale", "friction",
                "random_seed", "fused", "n_timesteps", "save_interval"):
        assert kw[key] == jkw[key], key
    assert ld.norm_factor == jld.norm_factor and ld.kb_inv == jld.kb_inv
    assert ld.sim.dt == jld.sim.dt and ld.sim.beta == jld.sim.beta
    assert list(ld.sim.masses) == list(jld.sim.masses)
    resolved = jlang.resolve_fused_mode(jax_seen["gd"].model, jkw["fused"], CHAINS, "cpu")
    assert ld.force_fn.mode == resolved == "never"
    assert ours["reference_temp"] == jax_seen["reference_temp"]
    assert (ours["reference_temp"] is not None) == ("tempering" in case)
    assert written.shape == (CHAINS * 20 // kw["save_interval"], STAGED[name], 3)


def test_cli_with_a_data_folder_resolves_the_jax_settings(tmp_path, monkeypatch):
    """``--data_folder`` with a synthetic fast-folder file (nm) written here:
    both CLIs load the dataset and resolve the same Langevin settings; the
    norm factor stays the molecule's, as in the empty-dataset mode."""
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "CLN025-0-c-alpha.npy",
            np.random.default_rng(2).normal(size=(50, 10, 3)).astype(np.float32))
    _, jax_seen, ours = _run_both("chain10", CASES["langevin"] + ["--data_folder", str(data)],
                                  tmp_path, monkeypatch)
    for key in ("t", "temp_data", "temp_sim", "masses", "dt", "dt_scale"):
        assert ours["ld_kwargs"][key] == jax_seen["ld_kwargs"][key], key
    assert ours["ld"].norm_factor == jax_seen["ld"].norm_factor == 3.113133430480957
    assert ours["ld"].sim.dt == jax_seen["ld"].sim.dt


@pytest.mark.parametrize("fused", ["never", "auto", "cl", "clx", "always"])
def test_fused_flag_maps_to_the_jax_sampler_kernel(fused, tmp_path, monkeypatch):
    """``--fused`` -> the sampler's kernel: always -> packed, cl, clx as
    named, auto -> the gate (the plain network on the CPU), never -> plain."""
    _, jax_seen, ours = _run_both("chain10", ["--gen_mode", "iid", "--fused", fused,
                                              "--sample_steps", "2"], tmp_path, monkeypatch)
    expected = {"never": "xla", "auto": "xla", "cl": "cl", "clx": "clx", "always": "packed"}
    assert ours["sampler_kernel"] == jax_seen["sampler_kernel"] == expected[fused]


def _check_outputs(path, mode, frames, n):
    """The three files of a run: the .npy, the same array in the .pt, and
    the first 1000 frames as PDB models that reload with n residues."""
    folder = os.path.join(path, f"main_eval_output_{mode}")
    arr = np.load(os.path.join(folder, f"sample-{mode}.npy"))
    assert arr.shape == (frames, n, 3) and arr.dtype == np.float32 and np.isfinite(arr).all()
    pt = torch.load(os.path.join(folder, f"sample-{mode}.pt"))
    np.testing.assert_array_equal(pt.numpy(), arr)
    pdb = os.path.join(folder, f"sample-{mode}.pdb")
    first = load_pdb(pdb)
    assert first.topology.n_residues == n
    np.testing.assert_allclose(first.xyz, arr[0], atol=1e-3)
    with open(pdb) as f:
        assert sum(line.startswith("MODEL") for line in f) == min(frames, 1000)
    return arr


def test_langevin_samples_match_jax_loop(tmp_path, monkeypatch):
    """chain10, 8 chains, 10 steps saved every 5, the CLI's defaults
    otherwise (auto-dt, masses 12, 340 K, t = 20, the plain network). The
    port's CLI runs for real with a numpy initial state in place of its
    i.i.d. draw and numpy noise through ``sim._draw_noise``; the reference is
    the JAX BAOAB loop at the settings the JAX CLI resolved, on the same
    state and noise. Tolerance 1e-4 of the largest coordinate, as in
    tests/test_torch_dynamics.py."""
    argv = ["--gen_mode", "langevin", "--parallel_sim", str(CHAINS),
            "--batch_size_gen", str(CHAINS), "--n_timesteps", "10", "--save_interval", "5"]
    rng = np.random.default_rng(5)
    init = rng.normal(size=(CHAINS, 10, 3)).astype(np.float32)
    init = (init - init.mean(axis=1, keepdims=True)) * 3.113133430480957
    noise = rng.normal(size=(10, CHAINS, 10, 3)).astype(np.float32)

    with monkeypatch.context() as m:
        seen = _record(m, "jax", jlang.LangevinDiffusion, jcli, jeval)
        seen["num_atoms"] = 10
        _jax_sampler_kernels(m, seen)
        jcli.main(["--model_path", _copy("chain10", tmp_path, "jax"), *argv])
    jld, kw = seen["ld"], seen["ld_kwargs"]
    sim = jld.sim
    force_fn = jax.jit(jlang.make_diffusion_force_fn(
        seen["gd"], seen["params"], kw["t"], jld.kb_inv / kw["temp_data"]))
    x, v = jnp.asarray(init / jld.norm_factor), jnp.zeros((CHAINS, 10, 3))
    frames = []
    for k in range(10):
        x = jcenter(x)
        _, forces = force_fn(x)
        x, v = jint.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt, sim._masses,
                               sim.vscale, sim.noisescale, sim.beta)
        if (k + 1) % 5 == 0:
            frames.append(np.asarray(x))
    ref = np.stack(frames, axis=1).reshape(-1, 10, 3) * jld.norm_factor

    class InjectedNoise(tcli.LangevinDiffusion):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            draws = iter(torch.from_numpy(noise))
            self.sim._draw_noise = lambda like: next(draws)

    path = _copy("chain10", tmp_path, "torch")
    monkeypatch.setattr(tcli, "sample_from_model", lambda fn, num, *a, **k: init[:num])
    monkeypatch.setattr(tcli, "LangevinDiffusion", InjectedNoise)
    out = tcli.main(["--model_path", path, *argv, "--device", "cpu"])
    assert out.shape == (2 * CHAINS, 10, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    np.testing.assert_array_equal(_check_outputs(path, "langevin", 2 * CHAINS, 10), out)


def test_iid_samples_match_jax_cli(tmp_path, monkeypatch):
    """chain10 DDIM-4, 12 samples in batches of 8 (the remainder batch
    samples a full batch), seed 3: the port's CLI with each batch's noise
    rebuilt from the JAX CLI's key splits (``split`` per batch, then the
    chain's own ``split`` and ``fold_in``) against the JAX CLI's output.
    Held at the DDIM-20 gate, in units of norm_factor: rms <= 1e-3, worst
    coordinate <= 5e-2."""
    from test_torch_diffusion import _jax_noise_hook

    args = ["--gen_mode", "iid", "--num_samples_eval", "12", "--batch_size_gen", str(CHAINS),
            "--sample_steps", "4", "--seed", "3"]
    ref = np.asarray(jcli.main(["--model_path", _copy("chain10", tmp_path, "jax"), *args]))

    key, batch_keys = jax.random.PRNGKey(3), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        batch_keys.append(sub)
    make = GaussianDiffusion.make_sample_fn  # the plain network's sampler (--fused never)

    def with_jax_noise(self, *a, **k):
        fn, keys = make(self, *a, **k), iter(batch_keys)

        def sample(generator=None, noise=None):
            return fn(noise=_jax_noise_hook(next(keys)))

        sample.kernel = fn.kernel
        return sample

    monkeypatch.setattr(GaussianDiffusion, "make_sample_fn", with_jax_noise)
    path = _copy("chain10", tmp_path, "torch")
    got = tcli.main(["--model_path", path, *args, "--device", "cpu"])
    assert got.shape == ref.shape == (12, 10, 3)
    diff = (got - ref) / 3.113133430480957
    assert np.sqrt(np.mean(diff**2)) <= 1e-3 and np.abs(diff).max() <= 5e-2
    np.testing.assert_array_equal(_check_outputs(path, "iid", 12, 10), got)


def test_load_model_reads_a_reference_pt_checkpoint(tmp_path):
    """A results directory holding ``config.json`` and a reference-layout
    ``model-best.pt`` (no msgpack) loads the staged weights exactly and
    samples through the CLI; a missing checkpoint raises."""
    from twoforone_torch.utils.convert import build_ema_pytorch_state_dict

    gd, params, trainset, cfg = tcli.load_model(trained_dir("chain10"), "best", device="cpu")
    assert gd.norm_factor == trainset.std and cfg.mol == "chignolin"
    state = build_ema_pytorch_state_dict(gd, params)
    path = tmp_path / "from_pt"
    path.mkdir()
    shutil.copy(os.path.join(trained_dir("chain10"), "config.json"), path)
    torch.save({"ema": {k: torch.tensor(v) for k, v in state.items()}}, path / "model-best.pt")
    _, got, _, _ = tcli.load_model(str(path), "best", device="cpu")
    for (k, a), (k2, b) in zip(sorted(_leaves(got)), sorted(_leaves(params))):
        assert k == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    with pytest.raises(FileNotFoundError, match="No checkpoint last"):
        tcli.load_model(str(path), "last", device="cpu")
    out = tcli.main(["--model_path", str(path), "--num_samples_eval", "3", "--batch_size_gen",
                     "3", "--sample_steps", "2", "--device", "cpu"])
    assert out.shape == (3, 10, 3) and np.isfinite(out).all()


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """The default ``--device cuda`` raises without CUDA instead of running
    on the host, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _copy("chain10", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--model_path", path])
    assert sorted(os.listdir(path)) == sorted(os.listdir(trained_dir("chain10")))


@pytest.mark.parametrize("mode", ["iid", "langevin"])
def test_bf16_runs_the_bf16_network(mode, tmp_path, monkeypatch):
    """``--bf16`` on a copy of chain10 (``--fused auto``, which is the plain
    network off the card): both CLIs hand the flag to the same places (the
    LangevinDiffusion; the plain i.i.d. sampler), and a real run writes finite
    samples that differ from the float32 run's with the same seed."""
    args = (["--gen_mode", "iid", "--sample_steps", "4"] if mode == "iid" else
            ["--gen_mode", "langevin", "--n_timesteps", "10", "--save_interval", "5",
             "--sample_steps", "4"])
    args += ["--fused", "auto", "--bf16"]
    _, jax_seen, ours = _run_both("chain10", args, tmp_path / "recorded", monkeypatch)
    assert ours["sampler_kernel"] == jax_seen["sampler_kernel"] == "xla"
    if mode == "langevin":
        assert ours["ld_kwargs"]["bf16"] is jax_seen["ld_kwargs"]["bf16"] is True
        assert ours["ld"].force_fn.mode == "never"
    wrapped = []
    with_dtype = GraphTransformer.with_dtype
    monkeypatch.setattr(GraphTransformer, "with_dtype",
                        lambda self, dt: wrapped.append(dt) or with_dtype(self, dt))
    argv = ["--num_samples_eval", "6", "--batch_size_gen", "6", "--parallel_sim", "4",
            "--device", "cpu", *args]
    out = {}
    for bf16 in (False, True):
        path = _copy("chain10", tmp_path, f"bf16_{bf16}")
        out[bf16] = tcli.main(["--model_path", path, *(a for a in argv if bf16 or a != "--bf16")])
    frames = 6 if mode == "iid" else 4 * 2
    assert out[True].shape == out[False].shape == (frames, 10, 3)
    assert np.isfinite(out[True]).all() and not np.array_equal(out[True], out[False])
    # the i.i.d. sampler's network and, for Langevin, also the force's
    assert wrapped == [torch.bfloat16] * (1 if mode == "iid" else 2)
