"""Port's positive control against the JAX package's, on the CPU: presets,
scorers, bar predicates, and tiny end-to-end runs of both controls.

Tolerances: the presets and the bar predicates are compared exactly. The
scorers read float32 features in both packages (dihedrals and distances:
the JAX package's jnp, the port's torch): ``dihedral_js``, ``pwd_js`` and
the TIC JS within 1e-6 (a feature within rounding of a histogram bin edge
could fall on either side of it; on these inputs none does), the TIC bin
edges within 1e-6 of their span. The end-to-end
runs are the port's alone (the JAX side needs no training run): their keys
are those the JAX functions write (read from the JAX source), and their
floors, which depend only on the seeds, equal the JAX scorers' on the JAX
package's draws of the same seeds.
"""

import ast
import os

import numpy as np
import pytest

import twoforone_tpu.data.synthetic as jsyn
import twoforone_tpu.train.positive_control as jpc
import twoforone_torch.train.positive_control as tpc
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from twoforone_torch.train.trainer import Trainer
from twoforone_torch.utils.artifacts import load_results, trained_dir

STAGED = sorted(os.listdir(os.path.dirname(trained_dir("chain10"))))
TINY_CHAIN = dict(n_beads=10, train_iter=50, n_data=2000, batch_size=64, hidden_nf=16,
                  n_layers=1, num_samples=64, langevin_chains=8, langevin_steps=200,
                  langevin_save_interval=50, timesteps=100, eval_samples=2000,
                  fused="auto", device="cpu")
TINY_DIPEPTIDE = dict(train_iter=40, n_data=2000, batch_size=64, hidden_nf=16, n_layers=1,
                      num_samples=256, langevin_chains=8, langevin_steps=200,
                      langevin_save_interval=50, t_noise=4, n_bins=31, timesteps=100,
                      final_eval_samples=32, device="cpu")


def _jax_result_keys(func_name, skip_if=None):
    """The keys the JAX function writes into its ``results`` dict, read from
    its source; an ``if <skip_if>:`` block (bf16_compare) is left out."""
    with open(jpc.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func_name)
    keys = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if (isinstance(child, ast.If) and isinstance(child.test, ast.Name)
                    and child.test.id == skip_if):
                continue
            if isinstance(child, ast.Assign):
                for tgt in child.targets:
                    if (isinstance(tgt, ast.Name) and tgt.id == "results"
                            and isinstance(child.value, ast.Dict)):
                        keys.update(k.value for k in child.value.keys)
                    elif (isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name)
                          and tgt.value.id == "results"):
                        keys.add(tgt.slice.value)
            visit(child)

    visit(fn)
    return keys


def test_presets_equal_jax():
    assert tpc.CHAIN_CONTROL_PRESETS == jpc.CHAIN_CONTROL_PRESETS
    assert tpc.ALA5_CONTROL_PRESET == jpc.ALA5_CONTROL_PRESET
    for n in tpc.CHAIN_CONTROL_PRESETS:
        preset = jpc.CHAIN_CONTROL_PRESETS[n]
        want = (jsyn.CHAIN10_TORSION_COMPONENTS if preset["components_seed"] is None else
                jsyn.make_chain_components(n - 3, n_slow=preset["n_slow"],
                                           seed=preset["components_seed"]))
        assert tpc.chain_control_components(n) == want


def test_dihedral_and_pwd_js_match_jax():
    a = jsyn.bimodal_dipeptide_dataset(3000, seed=1)
    b = jsyn.bimodal_dipeptide_dataset(3000, seed=2)
    for n_bins in (31, 61):
        assert tpc.dihedral_js(a, b, n_bins) == pytest.approx(jpc.dihedral_js(a, b, n_bins),
                                                              rel=1e-6)
    assert tpc.pwd_js(a, b) == pytest.approx(jpc.pwd_js(a, b), rel=1e-6)
    assert tpc.dihedral_js(a, a) == 0.0 and tpc.pwd_js(a, a) == 0.0


@pytest.mark.parametrize("n_beads", [10, 20])
def test_synthetic_tic_scorer_matches_jax(n_beads):
    comps = tpc.chain_control_components(n_beads)
    ref_traj = jsyn.chain_trajectory(4000, comps, seed=10)
    ref_eq = jsyn.chain_dataset(3000, comps, seed=11)
    port, jax_ = tpc.SyntheticTicScorer(ref_traj, ref_eq), jpc.SyntheticTicScorer(ref_traj, ref_eq)
    for edges, jedges in ((port.ex, jax_.ex), (port.ey, jax_.ey)):
        np.testing.assert_allclose(edges, jedges, rtol=0, atol=1e-6 * np.ptp(jedges))
    rng = np.random.default_rng(0)
    cases = (jsyn.chain_dataset(3000, comps, seed=12),
             jsyn.chain_dataset(3000, comps, seed=13) + rng.normal(scale=0.3, size=(3000, n_beads, 3)),
             rng.normal(size=(500, n_beads, 3)) * 50.0)  # far outside the bins: log 2
    for xyz in cases:
        assert port.tic_js(xyz) == pytest.approx(jax_.tic_js(xyz), rel=1e-6, abs=1e-9)
    assert port.tic_js(cases[2]) == pytest.approx(np.log(2))


def _bar_cases():
    good = dict(tic_js_floor=0.025, tic_js_iid=0.04, tic_js_langevin=0.08, pwd_js_iid=1e-4,
                nonfinite_frac_iid=0.0, nonfinite_frac_langevin=0.0)
    good_erg = dict(good, langevin_ergodic=True, langevin_min_hop_fraction=0.146,
                    langevin_max_occupancy_error=0.069)
    dip = dict(js_floor=0.015, js_iid=0.016, js_langevin_f32=0.035, pwd_js_iid=1e-4,
               js_bf16_vs_f32=0.009, nonfinite_frac_iid=0.0, nonfinite_frac_langevin=0.0)
    cases = [good, good_erg, dict(good, tic_js_iid=0.05), dict(good, tic_js_langevin=0.11),
             dict(good, pwd_js_iid=0.02), dict(good, nonfinite_frac_iid=1e-3),
             dict(good, nonfinite_frac_langevin=1e-3), dict(good_erg, langevin_ergodic=False),
             dict(good_erg, langevin_min_hop_fraction=0.05),
             dict(good_erg, langevin_max_occupancy_error=0.2)]
    dips = [dip, {k: v for k, v in dip.items() if k != "js_bf16_vs_f32"},
            dict(dip, js_iid=0.04), dict(dip, js_langevin_f32=0.06), dict(dip, pwd_js_iid=0.02),
            dict(dip, js_bf16_vs_f32=0.03), dict(dip, nonfinite_frac_iid=1e-3),
            {k: v for k, v in dip.items() if k != "nonfinite_frac_langevin"},
            dict(dip, langevin_ergodic=True, langevin_min_hop_fraction=0.05)]
    return cases, dips


@pytest.mark.parametrize("name", STAGED)
def test_bar_predicates_agree_with_jax_on_staged_results(name):
    res = load_results(name)
    cases, dips = _bar_cases()
    if name == "ala5":
        assert tpc.dipeptide_bars_ok(res) is jpc.dipeptide_bars_ok(res) is True
        for case in dips:
            assert tpc.dipeptide_bars_ok(case) == jpc.dipeptide_bars_ok(case), case
    else:
        assert tpc.physics_bars_ok(res) is jpc.physics_bars_ok(res) is True
        for case in cases:
            assert tpc.physics_bars_ok(case) == jpc.physics_bars_ok(case), case
    assert tpc.ergodicity_bars_ok(res) == jpc.ergodicity_bars_ok(res) is True
    for case in cases + dips:
        assert tpc.ergodicity_bars_ok(case) == jpc.ergodicity_bars_ok(case), case


def test_bf16_compare_runs_the_bf16_stage(tmp_path, monkeypatch):
    """``bf16_compare=False`` leaves out the bfloat16 Langevin stage and its
    three keys; ``True`` (the default, as in the JAX package) runs it in
    segments as the float32 stage runs, through the bfloat16 network, from
    the same initial states and seed: a trajectory of the float32 stage's
    shape that is not its copy. Without the trainer's evaluators no
    Ramachandran map is drawn."""
    import torch

    from twoforone_torch.models.graph_transformer import GraphTransformer

    tiny = dict(TINY_DIPEPTIDE, train_iter=10, langevin_steps=100, evaluators=False)
    off = tpc.run_positive_control(results_folder=str(tmp_path / "off"), bf16_compare=False,
                                   **tiny)
    assert set(off) == _jax_result_keys("run_positive_control", skip_if="bf16_compare")
    wrapped = []
    with_dtype = GraphTransformer.with_dtype
    monkeypatch.setattr(GraphTransformer, "with_dtype",
                        lambda self, dt: wrapped.append(dt) or with_dtype(self, dt))
    calls = _counting(monkeypatch)
    folder = str(tmp_path / "on")
    on = tpc.run_positive_control(results_folder=folder, **tiny)
    assert set(on) - set(off) == {"js_langevin_bf16", "js_bf16_vs_f32", "pwd_js_bf16_vs_f32"}
    assert wrapped == [torch.bfloat16] and calls["segmented"] == 2
    suffix = "_t4_dt1_s100.npy"
    f32 = np.load(os.path.join(folder, "post_langevin_f32" + suffix))
    bf16 = np.load(os.path.join(folder, "post_langevin_bf16" + suffix))
    assert bf16.shape == f32.shape == (8 * 2, 5, 3) and np.isfinite(bf16).all()
    assert not np.array_equal(bf16, f32)
    assert np.isfinite(on["js_bf16_vs_f32"]) and np.isfinite(on["pwd_js_bf16_vs_f32"])
    assert not [f for _, _, fs in os.walk(folder) for f in fs if f.startswith("ramachandran")]


@pytest.mark.parametrize("run", ["run_chain_control", "run_positive_control"])
def test_runs_need_cuda_unless_cpu(run, monkeypatch, tmp_path):
    """The default device is CUDA: without it a run raises before it makes
    data, and no run falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tpc, run)(results_folder=str(tmp_path))
    assert not os.listdir(tmp_path)


def _counting(monkeypatch):
    """Counts of Trainer.sample and Trainer._train_step calls, and of the
    segmented Langevin runs."""
    calls = {"sample": 0, "train_step": 0, "segmented": 0}

    def wrap(owner, name, key):
        orig = getattr(owner, name)

        def counted(*args, **kwargs):
            calls[key] += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)

    wrap(Trainer, "sample", "sample")
    wrap(Trainer, "_train_step", "train_step")
    wrap(tpc, "segmented_sample", "segmented")
    return calls


def test_tiny_chain_control_keys_floor_and_resume(tmp_path, monkeypatch):
    calls = _counting(monkeypatch)
    folder = str(tmp_path / "chain10")
    res = tpc.run_chain_control(results_folder=folder, **TINY_CHAIN)
    assert set(res) == _jax_result_keys("run_chain_control")
    assert all(np.isfinite(v) for k, v in res.items() if k != "results_folder"), res
    assert res["langevin_chains"] == 8 and res["langevin_steps"] == 200
    assert res["t_noise_langevin"] == 20 and res["langevin_dt_scale"] == 1.0
    comps = jsyn.CHAIN10_TORSION_COMPONENTS
    scorer = jpc.SyntheticTicScorer(jsyn.chain_trajectory(2000, comps, seed=10),
                                    jsyn.chain_dataset(2000, comps, seed=11))
    assert res["tic_js_floor"] == pytest.approx(
        scorer.tic_js(jsyn.chain_dataset(2000, comps, seed=12)), rel=1e-6)
    post = sorted(f for f in os.listdir(folder) if f.startswith("post_"))
    assert post == ["post_iid.npy", "post_langevin_t20_dt1_s200.npy"]
    assert not [f for f in os.listdir(folder) if "_seg" in f or "_state" in f]
    assert np.load(os.path.join(folder, post[1])).shape == (8 * 4, 10, 3)
    # final evaluation + the i.i.d. stage; 50 steps; one Langevin stage
    assert calls == {"sample": 2, "train_step": 50, "segmented": 1}

    mtimes = {f: os.stat(os.path.join(folder, f)).st_mtime_ns for f in post}
    again = tpc.run_chain_control(results_folder=folder, resume=True, **TINY_CHAIN)
    assert again == res
    # the rerun trains no step and recomputes no stage (the final
    # evaluation's sampling runs again, as in the JAX package)
    assert calls == {"sample": 3, "train_step": 50, "segmented": 1}
    assert mtimes == {f: os.stat(os.path.join(folder, f)).st_mtime_ns for f in post}


def test_tiny_positive_control_keys_floor_and_resume(tmp_path, monkeypatch):
    calls = _counting(monkeypatch)
    folder = str(tmp_path / "ala")
    res = tpc.run_positive_control(results_folder=folder, **TINY_DIPEPTIDE)
    assert set(res) == _jax_result_keys("run_positive_control")
    assert all(np.isfinite(v) for k, v in res.items() if k != "results_folder"), res
    ref = jsyn.bimodal_dipeptide_dataset(256, seed=1)
    floor = jsyn.bimodal_dipeptide_dataset(256, seed=2)
    assert res["js_floor"] == pytest.approx(jpc.dihedral_js(ref, floor, n_bins=31), rel=1e-6)
    assert res["pwd_js_floor"] == pytest.approx(jpc.pwd_js(ref, floor), rel=1e-6)
    # the trainer's evaluators drew the Ramachandran map
    plots = [f for _, _, fs in os.walk(folder) for f in fs if f.startswith("ramachandran")]
    assert plots
    # the evaluation at the last step, the final evaluation, the i.i.d.
    # stage; the float32 and bfloat16 Langevin stages
    assert calls == {"sample": 3, "train_step": 40, "segmented": 2}
    again = tpc.run_positive_control(results_folder=folder, resume=True, **TINY_DIPEPTIDE)
    assert again == res
    assert calls == {"sample": 4, "train_step": 40, "segmented": 2}


def test_chip_smoke_holds_the_jax_key_set():
    """The card's runs of run_chain_control and run_positive_control are
    held to key sets written in chip_smoke.py (the card has no JAX package):
    they are the JAX functions'."""
    import chip_smoke

    assert set(chip_smoke.CHAIN_CONTROL_KEYS) == _jax_result_keys("run_chain_control")
    assert set(chip_smoke.DIPEPTIDE_CONTROL_KEYS) == _jax_result_keys("run_positive_control")
