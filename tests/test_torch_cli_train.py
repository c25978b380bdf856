"""Port's training CLI against the JAX package's: the same argv gives the
same TrainConfig through both parsers, and a tiny run on a synthetic
alanine-dipeptide data folder writes the files the JAX CLI's test expects
(``tests/test_cli.py``), after which the port's sampling CLI reads them."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import twoforone_tpu.cli.train as jcli
import twoforone_torch.cli.train as tcli
from test_torch_checkpoint import one_torch_thread  # noqa: F401 (autouse)

ARGVS = [
    [],
    ["--mol", "alanine_dipeptide", "--fold", "3", "--data_folder", "d", "--batch_size", "16",
     "--train_iter", "8", "--loss_weights", "higheruntil_100", "--ala2_train_cap", "500"],
    ["--mol", "chignolin", "--hidden_features_gnn", "64", "--num_layers_gnn", "3",
     "--use_intrinsic_coords", "true", "--use_abs_coords", "false", "--use_distances", "false",
     "--conservative", "true", "--min_lr_cosine_anneal", "None", "--t_diff_interval", "[0, 100]",
     "--langevin_t_diff", "12", "15", "--r_max", "none", "--traindata_subset", "null",
     "--gradient_accumulate_every", "2", "--steps_per_host_loop", "50", "--seed", "3"],
    ["--mol", "protein_g", "--data_aug", "no", "--scale_data", "0", "--eval_langevin", "yes",
     "--iterations_on_val", "0.5", "--weight_decay", "0.1", "--pick_checkpoint", "last",
     "--multihost", "false", "--coordinator_address", "h:1", "--num_processes", "2",
     "--process_id", "1"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parsers_give_the_same_config(argv):
    ours = tcli.config_from_args(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    theirs = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert set(ours.extra) - set(theirs.extra) == {"device"}


def test_parsers_have_the_same_flags():
    ours = {a.dest: a.default for a in tcli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert {k: ours[k] for k in theirs} == theirs
    assert ours["device"] == "cuda"


def test_multihost_and_a_missing_card_raise(monkeypatch):
    """``--multihost`` with a process count but no coordinator raises before
    anything is read (the JAX CLI's ``jax.distributed.initialize`` needs
    one off the TPU too)."""
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="no coordinator"):
        tcli.main(["--multihost", "true", "--num_processes", "2", "--process_id", "0",
                   "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--mol", "chignolin", "--data_folder", "None"])


def test_bf16_true_trains_a_bf16_model(data_folder, tmp_path):
    """``--bf16 true``: a short run trains a bfloat16 network on float32
    weights, as the JAX CLI's config does; the losses are finite and the
    checkpoint and config.json say so."""
    from twoforone_torch.utils.checkpoint import load_checkpoint

    trainer = tcli.main([
        "--mol", "alanine_dipeptide", "--data_folder", data_folder,
        "--results_folder", str(tmp_path), "--tensorboard_folder", str(tmp_path / "runs"),
        "--experiment_name", "bf16", "--hidden_features_gnn", "16", "--num_layers_gnn", "1",
        "--use_intrinsic_coords", "true", "--use_abs_coords", "false",
        "--use_distances", "false", "--batch_size", "16", "--train_iter", "4",
        "--eval_interval", "4", "--num_samples", "4", "--num_samples_final_eval", "4",
        "--iterations_on_val", "0.1", "--loss_weights", "higheruntil_10",
        "--ala2_train_cap", "500", "--diffusion_steps", "100", "--bf16", "true",
        "--device", "cpu"])
    assert trainer.config.bf16 and trainer.step == 4
    assert trainer.net.dtype == trainer.ema.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    assert math.isfinite(trainer.best_val_loss)
    state = load_checkpoint(trainer.results_folder, "last")
    leaves = [v for layer in state["params"].values() for v in layer.values()]
    assert all(np.asarray(v).dtype == np.float32 for v in leaves if not isinstance(v, dict))
    with open(os.path.join(trainer.results_folder, "config.json")) as f:
        assert json.load(f)["bf16"] is True


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(800, 5, 3)).astype(np.float32) * 0.9449
    np.savez(d / "ala2_cg_2fs_Hmass_2_HBonds.npz", coords=coords)
    return str(d)


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory, data_folder):
    """The JAX CLI test's run (tests/test_cli.py) with 100 diffusion steps
    instead of 1000 (and the higher weights on the first 10 instead of 100):
    the three evaluations' ancestral chains run eagerly on the CPU here."""
    out = tmp_path_factory.mktemp("results")
    trainer = tcli.main([
        "--mol", "alanine_dipeptide",
        "--data_folder", data_folder,
        "--results_folder", str(out),
        "--tensorboard_folder", str(out / "runs"),
        "--experiment_name", "clitest",
        "--hidden_features_gnn", "16",
        "--num_layers_gnn", "1",
        "--use_intrinsic_coords", "true",
        "--use_abs_coords", "false",
        "--use_distances", "false",
        "--conservative", "true",
        "--batch_size", "16",
        "--train_iter", "8",
        "--eval_interval", "4",
        "--num_samples", "4",
        "--num_samples_final_eval", "4",
        "--iterations_on_val", "0.1",
        "--log_tensorboard_interval", "4",
        "--loss_weights", "higheruntil_10",
        "--ala2_train_cap", "500",
        "--diffusion_steps", "100",
        "--device", "cpu",
    ])
    assert trainer.device.type == "cpu"
    return str(out / "clitest_")


def test_train_cli_artifacts(trained_dir):
    assert os.path.exists(os.path.join(trained_dir, "model-best.msgpack"))
    assert os.path.exists(os.path.join(trained_dir, "model-last.msgpack"))
    cfg = json.load(open(os.path.join(trained_dir, "config.json")))
    assert cfg["mol"] == "alanine_dipeptide_fuberlin"
    assert cfg["hidden_features_gnn"] == 16
    results = json.load(open(os.path.join(trained_dir, "results-final_iid_val.json")))
    assert "Dihedral JS" in results and math.isfinite(results["Dihedral JS"])
    for milestone in (1, 2):
        assert os.path.exists(os.path.join(trained_dir, f"results-{milestone}_iid.json"))


def test_sample_cli_reads_the_trained_dir(trained_dir, data_folder):
    from twoforone_torch.cli.sample import main

    out = main(["--model_path", trained_dir, "--gen_mode", "iid", "--num_samples_eval", "6",
                "--batch_size_gen", "4", "--sample_steps", "8", "--data_folder", data_folder,
                "--device", "cpu"])
    assert out.shape == (6, 5, 3) and np.isfinite(out).all()
    assert os.path.exists(os.path.join(trained_dir, "main_eval_output_iid", "sample-iid.npy"))
