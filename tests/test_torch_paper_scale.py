"""The port's paper-scale Langevin script
(``scripts/torch_paper_scale_langevin.py``) on the CPU, in miniature: 4
chains, 400 steps in 4 segments, a save every 50.

- A run SIGKILLed in its third segment, relaunched under
  ``TWOFORONE_PREEMPT_FLAG`` (the flag set the moment its next segment file
  is in place, so that it yields with exit code 75 at that boundary) and
  relaunched again gives the straight run's frames bit for bit, with 2
  resumes. Both processes start through ``chip_smoke.script_command``, as
  the card's run does, and find the straight run's norm-factor cache in
  ``--out`` (the straight run computed it). Every process runs one torch
  thread: the host's thread count changes float32 sums.
- Its ``results.json`` scores equal the JAX package's
  ``SyntheticTicScorer.tic_js`` (within 1e-6, as the positive control's
  parity test: float32 features, a feature within rounding of a bin edge
  could fall on either side) and ``slow_torsion_ergodicity`` (exactly) on
  the same frames.
- Without CUDA and without ``--device cpu`` the script raises.
"""

import json
import os
import shutil
import signal
import subprocess
import time

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)
from test_torch_workflow_scripts import script_module, unchanged_jax_tree

SCRIPT = "torch_paper_scale_langevin.py"
CHAINS, STEPS, SEGMENT, SAVE = 4, 400, 100, 50
N_SEGMENTS = STEPS // SEGMENT
ARGS = ["--chains", str(CHAINS), "--steps", str(STEPS), "--segment_steps", str(SEGMENT),
        "--save_interval", str(SAVE), "--device", "cpu"]
TOL_TIC_JS = 1e-6


def _frames(out):
    return script_module("torch_paper_scale_langevin").segment_frames(out, N_SEGMENTS)


def _results(out):
    with open(os.path.join(out, "results.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("straight"))
    with unchanged_jax_tree():
        script_module("torch_paper_scale_langevin").main(["--out", out, *ARGS])
    return out


def test_killed_and_preempted_run_is_bit_identical(straight, tmp_path):
    out = str(tmp_path / "resumed")
    os.makedirs(out)
    shutil.copy(os.path.join(straight, "norm_factor.json"), out)
    argv = ["--out", out, *ARGS]
    seg = lambda s: os.path.join(out, f"coords_seg{s:03d}.npy")  # noqa: E731
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("TWOFORONE_PREEMPT_FLAG", None)
    with unchanged_jax_tree():
        first = subprocess.Popen(chip_smoke.script_command(SCRIPT, argv), env=env,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        t0 = time.monotonic()
        while not os.path.exists(seg(1)) and first.poll() is None:
            assert time.monotonic() - t0 < 300
            time.sleep(0.01)
        first.send_signal(signal.SIGKILL)
        first.wait()
        assert first.returncode == -signal.SIGKILL and not os.path.exists(seg(2))

        flag = str(tmp_path / "preempt.flag")
        second = subprocess.run(
            chip_smoke.script_command(SCRIPT, argv, flag, os.path.basename(seg(2))),
            env=dict(env, TWOFORONE_PREEMPT_FLAG=flag), capture_output=True, timeout=300)
        assert second.returncode == 75, second.stderr.decode()[-2000:]
        assert os.path.exists(seg(2)) and not os.path.exists(seg(3))
        os.remove(flag)
        script_module("torch_paper_scale_langevin").main(argv)

    np.testing.assert_array_equal(_frames(out), _frames(straight))
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["resumes"] == 2 and meta["segments_done"] == N_SEGMENTS
    resumed, ref = _results(out), _results(straight)
    assert resumed["resumes"] == 2 and ref["resumes"] == 0
    for key in ("frames_saved", "nonfinite_chain_frac", "tic_js_langevin",
                "langevin_min_hop_fraction", "langevin_max_occupancy_error",
                "langevin_ergodic", "min_median_hops_per_chain", "workload"):
        assert resumed[key] == ref[key], key
    assert sorted(os.listdir(out)) == sorted(os.listdir(straight))


def test_results_score_as_the_jax_package(straight):
    """results.json against the JAX scorer and ergodicity report on the
    same frames; its key set is the JAX script's."""
    from test_torch_workflow_scripts import SCRIPTS, _dict_keys
    from twoforone_tpu.data.synthetic import (
        CHAIN10_TORSION_COMPONENTS,
        chain_dataset,
        chain_trajectory,
    )
    from twoforone_tpu.evaluate.ergodicity import slow_torsion_ergodicity
    from twoforone_tpu.train.positive_control import SyntheticTicScorer

    res = _results(straight)
    assert set(res) == _dict_keys(os.path.join(SCRIPTS, "paper_scale_langevin.py"), "main",
                                  "results")
    frames = _frames(straight)
    assert frames.shape == (CHAINS, STEPS // SAVE, 10, 3) and np.isfinite(frames).all()
    assert res["frames_saved"] == CHAINS * STEPS // SAVE and res["resumes"] == 0
    scorer = SyntheticTicScorer(
        chain_trajectory(200000, CHAIN10_TORSION_COMPONENTS, seed=10),
        chain_dataset(50000, CHAIN10_TORSION_COMPONENTS, seed=11),
    )
    assert abs(res["tic_js_langevin"] - scorer.tic_js(frames.reshape(-1, 10, 3))) <= TOL_TIC_JS
    erg = slow_torsion_ergodicity(frames, CHAIN10_TORSION_COMPONENTS)
    assert res["langevin_min_hop_fraction"] == erg["min_hop_fraction"]
    assert res["langevin_max_occupancy_error"] == erg["max_occupancy_error"]
    assert res["langevin_ergodic"] == erg["ergodic"]
    assert res["min_median_hops_per_chain"] == min(
        s["median_hops_per_chain"] for s in erg["per_torsion"].values())
    with open(os.path.join(straight, "norm_factor.json")) as f:
        assert json.load(f)["norm_factor"] == 1.3477803468704224


def test_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script_module("torch_paper_scale_langevin").main(["--out", str(out), "--chains", "4"])
    assert not out.exists()
