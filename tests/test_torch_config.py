"""Port's configuration layer (TrainConfig, load_config, get_model) and the
reference-checkpoint conversion against the JAX package's, on every staged
artifact."""

import argparse
import dataclasses
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.models import get_model as jget_model
from twoforone_tpu.utils import config as jconfig
from twoforone_tpu.utils import convert as jconvert
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.models import get_model
from twoforone_torch.utils import config as tconfig
from twoforone_torch.utils import convert as tconvert
from twoforone_torch.utils.artifacts import load_ema_params, trained_dir
from twoforone_torch.utils.convert import params_from_jax

from test_torch_checkpoint import _leaves

STAGED = {"ala5": 5, "chain10": 10, "chain20": 20, "chain28": 28, "chain35": 35, "chain56": 56}
MODEL_FIELDS = ("num_beads", "hidden_nf", "n_layers", "use_intrinsic_coords",
                "use_abs_coords", "use_distances", "conservative", "heads", "dim_head")
UNPLUMBED = [("use_rbf", True), ("residual_edge", False), ("graph_mlp_decoder", True),
             ("gnn_efficient", True), ("use_layernorm", False), ("sum_energies", False)]


def _same_config(got, ref):
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.extra == ref.extra


def _same_tree(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        assert np.asarray(got[k]).dtype == np.asarray(r).dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)


@pytest.mark.parametrize("name", sorted(STAGED))
def test_load_config_matches_jax(name, tmp_path):
    """config.json of every staged artifact: the same fields, the same
    ``extra``, the same JSON written back (read by the other package)."""
    got, ref = tconfig.load_config(trained_dir(name)), jconfig.load_config(trained_dir(name))
    _same_config(got, ref)
    got.to_json(str(tmp_path / "config.json"))
    _same_config(jconfig.load_config(str(tmp_path)), ref)
    _same_config(tconfig.TrainConfig.from_json(str(tmp_path / "config.json")), got)


@pytest.mark.parametrize("name", sorted(STAGED))
def test_get_model_builds_the_jax_architecture(name):
    """The same widths, layers, heads and edge flags as the JAX network, and
    parameters of the same names and shapes: the JAX module's parameter tree
    (from its own init, shapes only) maps onto the port's module strictly,
    and so do the staged weights."""
    cfg = tconfig.load_config(trained_dir(name))
    model, jmodel = get_model(cfg, STAGED[name]), jget_model(cfg, STAGED[name])
    for field in MODEL_FIELDS:
        assert getattr(model, field) == getattr(jmodel, field), field
    jgd = JGD(model=jmodel, num_atoms=STAGED[name])
    shapes = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ours = model.state_dict()
    theirs = params_from_jax(zeros)
    assert ours.keys() == theirs.keys()
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    model.load_state_dict(params_from_jax(load_ema_params(name)))


@pytest.mark.parametrize("flag,bad_value", UNPLUMBED + [("bf16", True)])
def test_get_model_refuses_what_it_cannot_build(flag, bad_value):
    """A reference flag that never reaches the network is refused by both
    packages; ``bf16`` is built by both: a bfloat16 network on float32
    parameters."""
    base = dict(hidden_features_gnn=16, num_layers_gnn=1, use_intrinsic_coords=True,
                use_abs_coords=False, use_distances=False, conservative=True)
    assert get_model(tconfig.TrainConfig(**base), 5).dtype is None
    cfg = tconfig.TrainConfig(**base, **{flag: bad_value})
    if flag == "bf16":
        model = get_model(cfg, 5)
        assert model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert jget_model(jconfig.TrainConfig(**base, bf16=True), 5).dtype == jnp.bfloat16
    else:
        with pytest.raises(ValueError, match=flag):
            get_model(cfg, 5)
        with pytest.raises(ValueError, match=flag):
            jget_model(jconfig.TrainConfig(**base, **{flag: bad_value}), 5)
    with pytest.raises(ValueError, match="not implemented"):
        get_model(argparse.Namespace(**base, backbone_network="egnn"), 5)


def test_legacy_args_pickle_matches_jax(tmp_path, monkeypatch):
    """A reference ``args.pickle``: an argparse Namespace holding an object of
    a module that cannot be imported where it is read (a torch activation,
    say), a tuple and an unknown key. Both loaders keep the plain values, turn
    the tuple into a list and drop the object."""
    fake = types.ModuleType("reference_only_activations")

    class Tanh:
        pass

    Tanh.__module__, Tanh.__qualname__ = fake.__name__, "Tanh"
    fake.Tanh = Tanh
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    ns = argparse.Namespace(mol="chignolin", hidden_features_gnn=32, num_layers_gnn=2,
                            activation=Tanh(), langevin_t_diff=(5, 12), hidden_size=7,
                            data_folder=None, scale_data=False)
    with open(tmp_path / "args.pickle", "wb") as f:
        pickle.dump(ns, f)
    monkeypatch.delitem(sys.modules, fake.__name__)
    got, ref = tconfig.load_config(str(tmp_path)), jconfig.load_config(str(tmp_path))
    _same_config(got, ref)
    assert got.langevin_t_diff == [5, 12] and got.extra == {"hidden_size": 7}
    assert got.shuffle_data_before_splitting  # __post_init__: not alanine
    os.remove(tmp_path / "args.pickle")
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(str(tmp_path))


@pytest.fixture(scope="module")
def chain10_pt(tmp_path_factory):
    """A reference-layout ``model-best.pt`` made from chain10's EMA weights by
    the JAX package's exporter: ``{"ema": EMA(GaussianDiffusion) state dict}``
    with torch tensors, as the reference trainer saves it."""
    from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT

    cfg = jconfig.load_config(trained_dir("chain10"))
    jmodel = JGT(num_beads=10, hidden_nf=64, n_layers=3, conservative=True,
                 use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
    jgd = JGD(model=jmodel, num_atoms=10, loss_weights=cfg.loss_weights)
    params = load_ema_params("chain10")
    state = jconvert.build_ema_pytorch_state_dict(jgd, params, step=7)
    path = tmp_path_factory.mktemp("pt") / "model-best.pt"
    torch.save({"step": 7, "ema": {k: torch.tensor(np.asarray(v)) for k, v in state.items()}},
               path)
    return path, params, state, jgd


def test_torch_checkpoint_loads_as_the_jax_tree(chain10_pt):
    """Both ``load_torch_checkpoint_as_params`` give the staged EMA tree,
    exactly; the export of the port equals the JAX package's key for key."""
    path, params, state, jgd = chain10_pt
    model = get_model(tconfig.load_config(trained_dir("chain10")), 10)
    got = tconvert.load_torch_checkpoint_as_params(str(path), model)
    ref = jconvert.load_torch_checkpoint_as_params(str(path), jgd.model)
    _same_tree(got, jax.tree_util.tree_map(np.asarray, ref))
    _same_tree(got, params)
    gd = GaussianDiffusion(model=model, num_atoms=10, loss_weights=jgd.loss_weights)
    ours = tconvert.build_ema_pytorch_state_dict(gd, params, step=7)
    assert ours.keys() == state.keys()
    for k, v in state.items():
        assert ours[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_state_dict_round_trip_is_exact(chain10_pt):
    """flax tree -> reference state dict -> flax tree gives the same bits, in
    both directions, and the port's mapping equals the JAX package's."""
    _, params, state, _ = chain10_pt
    sd = tconvert.params_to_torch_state_dict(params, 3)
    ref_sd = jconvert.params_to_torch_state_dict(params, 3)
    assert sd.keys() == ref_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k], err_msg=k)
    _same_tree(tconvert.torch_state_dict_to_params(sd, 3), params)
    back = tconvert.params_to_torch_state_dict(tconvert.torch_state_dict_to_params(state, 3), 3)
    for k, v in back.items():
        np.testing.assert_array_equal(v, state[f"ema_model.model.{k}"], err_msg=k)
    with pytest.raises(ValueError, match="graph-transformer"):
        tconvert.torch_state_dict_to_params({"betas": np.zeros(3)}, 3)
