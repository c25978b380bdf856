"""Port's training path against the JAX package's, on the CPU.

- Rotations: the port's matrices for JAX's angles.
- One training step through the port's ``Trainer`` with the rotation, the
  timesteps and the noise JAX draws (its own key splits) injected: loss,
  KL-at-T and every gradient leaf against ``jax.value_and_grad`` of the JAX
  loss, on the staged chain10 weights, a non-conservative network and the
  default edge configuration.
- The optimizer against ``optax.adamw`` on the same gradients (cosine and
  constant rate), the EMA against ``ema_update``, accumulation, chunking,
  the KL running max and the end of a chunked run (the cases of
  ``tests/test_train.py``), checkpoints across both packages, and a short
  run end to end.

Gradient tolerance, set from CPU runs against a float64 evaluation of the
port's loss on the same inputs: a leaf may differ from JAX's by 1e-4 of its
largest entry plus JAX's own float32 distance from float64 on that leaf.
On chain10 both packages sit ~4e-6 of the leaf maximum from float64; on the
default edge configuration (squared distances on untrained weights) JAX's
float32 gradients sit up to 1.5e-4 from float64 and the port's 5e-5. A leaf
that is zero in exact arithmetic (the non-conservative decoder's bias: the
output is centred) is held at 1e-6 of the largest entry of any leaf.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import twoforone_tpu.train.ema as jema
import twoforone_tpu.utils.checkpoint as jckpt
from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
from twoforone_tpu.core.diffusion import normal_kl_at_T as jkl
from twoforone_tpu.core.diffusion import sample_timesteps
from twoforone_tpu.models import get_model as jget_model
from twoforone_tpu.ops.geometry import random_rotation as jrandom_rotation
from twoforone_tpu.ops.geometry import random_rotation_matrices as jrotations
from twoforone_tpu.ops.geometry import reverse_rotation as jreverse
from twoforone_tpu.utils.config import TrainConfig as JConfig
from twoforone_torch.core.diffusion import GaussianDiffusion
from twoforone_torch.core.diffusion import p_losses
from twoforone_torch.data.datasets import CGDataset
from twoforone_torch.data.molecules import FOLDED_PDB_DIR, Molecules
from twoforone_torch.data.pdb import load_pdb
from twoforone_torch.data.synthetic import chain10_dataset
from twoforone_torch.models import get_model
from twoforone_torch.models.graph_transformer import init_params, score_forward
from twoforone_torch.ops.geometry import (
    center_zero,
    random_rotation,
    random_rotation_matrices,
    reverse_rotation,
    rotate,
    rotation_matrices,
)
from twoforone_torch.train import ema as tema
from twoforone_torch.train.trainer import Trainer, batch_iterator
from twoforone_torch.utils.artifacts import load_ema_params, trained_dir
from twoforone_torch.utils.checkpoint import load_checkpoint, read_checkpoint
from twoforone_torch.utils.config import TrainConfig
from twoforone_torch.utils.convert import params_from_jax, params_to_jax
from twoforone_torch.utils.preempt import EXIT_PREEMPTED, exit_if_preempted

from test_torch_checkpoint import _leaves, one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return np.asarray(tree)


# ------------------------------------------------------------------ rotations
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_rotations_match_jax_for_the_same_angles(batch):
    """R = Rz Ry Rx from JAX's angles: the matrices, the rotated batch and
    its inverse within float32 rounding (2e-7 on unit matrices, 1e-6 of the
    largest coordinate)."""
    key = jax.random.PRNGKey(batch)
    thetas = np.asarray(jax.random.uniform(key, (3, batch), minval=-jnp.pi, maxval=jnp.pi))
    x = chain10_dataset(batch, seed=batch)
    rot = rotation_matrices(torch.from_numpy(thetas))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrotations(key, batch)), atol=2e-7)
    jx, jrot = jrandom_rotation(jnp.asarray(x), key, return_matrices=True)
    got = rotate(torch.from_numpy(x), rot)
    scale = np.abs(x).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=1e-6 * scale)
    back = reverse_rotation(got, rot)
    np.testing.assert_allclose(back.numpy(), np.asarray(jreverse(jx, jrot)), atol=1e-6 * scale)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-6 * scale)


def test_random_rotations_are_proper_and_reproducible():
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(chain10_dataset(256, seed=1))
    out, rot = random_rotation(x, gen, return_matrices=True)
    eye = torch.eye(3).expand(256, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), eye, atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.linalg.det(rot), torch.ones(256), atol=1e-6, rtol=0)
    again = random_rotation_matrices(torch.Generator().manual_seed(3), 256)
    assert torch.equal(rot, again)
    # distances are kept, the orientation is not
    torch.testing.assert_close(torch.cdist(out, out), torch.cdist(x, x), atol=1e-5, rtol=0)
    assert not torch.allclose(out, x, atol=1e-2)


# ------------------------------------------------------------ trainer set-up
def _topology(mol):
    if mol == "alanine":
        return load_pdb(os.path.join(FOLDED_PDB_DIR, "ala2_cg.pdb")).topology
    return load_pdb(os.path.join(FOLDED_PDB_DIR, f"{Molecules[mol].value}-0-c-alpha.pdb")).topology


def _chignolin_sets(n=96, seed=0):
    data = chain10_dataset(n, seed=seed)
    topo = _topology("CHIGNOLIN")
    cut = (n // 2, 3 * n // 4)
    return tuple(CGDataset(d, topo, Molecules.CHIGNOLIN)
                 for d in (data[: cut[0]], data[cut[0]: cut[1]], data[cut[1]:]))


def _synthetic_ala2(n=512):
    """Gaussian blob 'molecules' centred at zero, the JAX tests' data."""
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(n, 5, 3)).astype(np.float32) * 0.9449278712272644
    coords -= coords.mean(axis=1, keepdims=True)
    topo = _topology("alanine")
    return tuple(CGDataset(c, topo, "alanine_fold1")
                 for c in (coords[: n // 2], coords[n // 2: 3 * n // 4], coords[3 * n // 4:]))


CHAIN10 = json.load(open(os.path.join(trained_dir("chain10"), "config.json")))
SMALL = dict(hidden_features_gnn=32, num_layers_gnn=2)
CONFIGS = {
    "chain10": dict(CHAIN10),
    "non_conservative": dict(SMALL, conservative=False, use_intrinsic_coords=True,
                             use_abs_coords=False, use_distances=False),
    "default_edges": dict(SMALL),  # squared distances + absolute coordinates
}
NORM = 1.6
STEP_BATCH = 16


def _trainer(tmp_path, fields, datasets, **overrides):
    cfg = TrainConfig.from_dict(dict(fields, results_folder=str(tmp_path / "results"),
                                     tensorboard_folder=str(tmp_path / "runs"),
                                     data_folder=None, **overrides))
    n = datasets[0].num_beads
    gd = GaussianDiffusion(model=get_model(cfg, n), num_atoms=n, timesteps=cfg.diffusion_steps,
                           norm_factor=NORM, loss_weights=cfg.loss_weights)
    return Trainer(gd, datasets, cfg.mol, cfg, use_tensorboard=False, evaluators=False,
                   device=CPU)


def _jax_step_draws(key, gd, batch):
    """JAX's draws of one micro-batch, by its own splits: the rotation
    (trainer.py), t and the noise (diffusion.py loss / p_losses)."""
    b, n, _ = batch.shape
    aug_key, loss_key = jax.random.split(key)
    t_key, noise_key = jax.random.split(loss_key)
    thetas = jax.random.uniform(aug_key, (3, b), minval=-jnp.pi, maxval=jnp.pi)
    draws = {
        "rotation": rotation_matrices(torch.from_numpy(np.asarray(thetas))),
        "t": torch.from_numpy(np.asarray(sample_timesteps(gd.buffers, t_key, b, None))),
        "noise": torch.from_numpy(np.asarray(jax.random.normal(noise_key, (b, n, 3)))),
    }
    return aug_key, loss_key, draws


def _torch_f64_grads(trainer, params, mb, draws):
    """The port's loss and gradients in float64 on the same inputs."""
    net = get_model(trainer.config, mb.shape[1]).double()
    net.load_state_dict({k: v.double() for k, v in params_from_jax(params).items()})
    buf = trainer.gd.buffers
    buf = type(buf)(*(b.double() for b in buf))
    x0 = center_zero(rotate(torch.from_numpy(mb).double(), draws["rotation"].double())) / NORM
    loss = p_losses(buf, lambda x, tn: score_forward(net, x, tn, create_graph=True), x0,
                    draws["t"], draws["noise"].double())
    grads = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True)
    return params_to_jax({n: torch.zeros_like(p) if g is None else g
                          for (n, p), g in zip(net.named_parameters(), grads)})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_training_step_matches_jax(name, tmp_path):
    fields = CONFIGS[name]
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    if name == "chain10":
        params = load_ema_params("chain10")
    else:
        params = init_params(trainer.gd.model, 3)
    trainer.net.load_state_dict(params_from_jax(params))

    jcfg = JConfig.from_dict(fields)
    jgd = JGD(model=jget_model(jcfg, 10), num_atoms=10, timesteps=1000, norm_factor=NORM,
              loss_weights=jcfg.loss_weights)
    batch = chain10_dataset(STEP_BATCH, seed=5)
    aug_key, loss_key, draws = _jax_step_draws(jax.random.PRNGKey(7), jgd, batch)
    mb = jrandom_rotation(jnp.asarray(batch), aug_key)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgd.loss(p, mb, loss_key), has_aux=True))(_jax_tree(params))

    metrics = trainer._train_step(batch, torch.Generator(), draws=[draws])
    assert trainer.step == 1
    assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    # KL-at-T: JAX's jitted step reassociates -1 - log(1 - abar_T) +
    # (1 - abar_T) + ..., float32 noise of 0.5 |log(1 - abar_T)| = 1.2e-9
    # on a value of ~5e-8; the JAX function on the same normalized batch,
    # unjitted, agrees to 1e-5.
    xj = (mb - mb.mean(axis=1, keepdims=True)) / NORM
    assert float(metrics["kl_at_T"]) == pytest.approx(float(jkl(jgd.buffers, xj)), rel=1e-5)
    slack = 0.5 * abs(float(jgd.buffers.log_one_minus_alphas_cumprod[-1]))
    assert abs(float(metrics["kl_at_T"]) - float(jaux["kl_at_T"])) <= slack * 1.01
    assert float(metrics["kl_max"]) == float(metrics["kl_at_T"]) <= 1e-4

    got = params_to_jax({n: p.grad for n, p in trainer.net.named_parameters()})
    ref64 = _torch_f64_grads(trainer, params, batch, draws)
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(jleaves) == set(dict(_leaves(got)))
    largest = max(np.abs(g).max() for g in jleaves.values())
    for path, jg in jleaves.items():
        g, g64 = _leaf(got, path), _leaf(ref64, path)
        scale = max(np.abs(jg).max(), 1e-2 * largest)
        tol = 1e-4 * scale + np.abs(jg - g64).max()
        assert np.abs(g - jg).max() <= tol, (path, np.abs(g - jg).max() / scale)


def test_a_force_that_ignores_x_trains_with_zero_gradients(tmp_path):
    """The zero-feature configuration without absolute coordinates: the
    energy does not depend on x, the force is zero and so is every gradient,
    as in JAX; the update still runs (its weight decay)."""
    fields = dict(SMALL, use_intrinsic_coords=False, use_abs_coords=False, use_distances=False)
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    params = params_to_jax(trainer.net.state_dict())
    jgd = JGD(model=jget_model(JConfig.from_dict(fields), 10), num_atoms=10, norm_factor=NORM)
    batch = chain10_dataset(8, seed=1)
    _, loss_key, draws = _jax_step_draws(jax.random.PRNGKey(2), jgd, batch)
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jgd.loss(p, jnp.asarray(batch), loss_key),
                                            has_aux=True)(_jax_tree(params))
    assert all(not np.asarray(g).any() for g in jax.tree_util.tree_leaves(jgrads))
    metrics = trainer._train_step(batch, torch.Generator(), draws=[draws])
    assert all(not p.grad.any() for p in trainer.net.parameters())
    assert trainer.step == 1 and np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------------------ optimizer
@pytest.mark.parametrize("min_lr,weight_decay", [(1e-4, 1e-12), (1e-4, 0.1), (None, 1e-12)])
def test_adamw_matches_optax(min_lr, weight_decay, tmp_path):
    """Five updates with the same numpy gradients through the trainer's
    update and through ``optax.adamw`` with the JAX trainer's schedule
    (cosine over 4 updates, so the count passes its end; or constant):
    weights within 1e-6 of each leaf's largest entry, moments and counts
    equal in the checkpoint layout."""
    fields = dict(CONFIGS["non_conservative"], hidden_features_gnn=16, num_layers_gnn=1,
                  learning_rate=1e-3, min_lr_cosine_anneal=min_lr, weight_decay=weight_decay,
                  train_iter=4)
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    params0 = params_to_jax(trainer.net.state_dict())
    sched = (1e-3 if min_lr is None
             else optax.cosine_decay_schedule(1e-3, 4, alpha=min_lr / 1e-3))
    opt = optax.adamw(learning_rate=sched, weight_decay=weight_decay)
    jparams = _jax_tree(params0)
    jstate = opt.init(jparams)
    rng = np.random.default_rng(0)
    for _ in range(5):
        grads = {n: rng.normal(size=p.shape).astype(np.float32) * 0.1
                 for n, p in trainer.net.named_parameters()}
        trainer._update([torch.from_numpy(g) for g in grads.values()])
        updates, jstate = opt.update(_jax_tree(params_to_jax(
            {n: torch.from_numpy(g) for n, g in grads.items()})), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = params_to_jax(trainer.net.state_dict())
    for path, ref in _leaves(jax.tree_util.tree_map(np.asarray, jparams)):
        assert np.abs(_leaf(got, path) - ref).max() <= 1e-6 * np.abs(ref).max(), path
    saved = trainer._opt_state()
    jsd = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    assert set(saved) == set(jsd) and {k: set(v) for k, v in saved.items()} == {
        k: set(v) for k, v in jsd.items()}
    assert int(saved["0"]["count"]) == int(jsd["0"]["count"]) == 5
    for moment in ("mu", "nu"):
        for path, ref in _leaves(jsd["0"][moment]):
            np.testing.assert_allclose(_leaf(saved["0"][moment], path), ref, rtol=2e-6,
                                       atol=1e-12, err_msg=path)


# ------------------------------------------------------------------------ EMA
def test_ema_schedule_matches_ema_pytorch_semantics():
    cfg = tema.EMAConfig(beta=0.995)
    assert float(tema.current_decay(0, cfg)) == 0.0
    assert float(tema.current_decay(100, cfg)) == 0.0
    assert float(tema.current_decay(101, cfg)) == 0.0  # epoch = 0 -> still copy
    assert float(tema.current_decay(110, cfg)) == pytest.approx(1 - (1 + 9) ** (-2 / 3),
                                                                 rel=1e-5)
    assert float(tema.current_decay(100000, cfg)) == pytest.approx(0.995)
    for step in (0, 50, 101, 102, 110, 500, 5000, 100000):
        assert float(tema.current_decay(step, cfg)) == pytest.approx(
            float(jema.current_decay(step, jema.EMAConfig(beta=0.995))), rel=1e-6, abs=0)


def test_ema_update_every_and_copy():
    cfg = tema.EMAConfig(beta=0.9, update_after_step=2, update_every=2, power=1.0)
    net = torch.nn.Linear(3, 1, bias=False)
    torch.nn.init.ones_(net.weight)
    ema = tema.init_ema(net)
    torch.nn.init.zeros_(ema.weight)
    assert not ema.weight.requires_grad
    tema.ema_update(ema, net, 1, cfg)  # not a multiple of 2: unchanged
    assert torch.equal(ema.weight, torch.zeros(1, 3))
    tema.ema_update(ema, net, 2, cfg)  # a multiple of 2, epoch <= 0: copy
    assert torch.equal(ema.weight, torch.ones(1, 3))


def test_ema_matches_jax_over_120_calls():
    """New random weights at every call; the EMA equals JAX's bit for bit
    while it copies (calls 0-101) and within 1e-6 after."""
    cfg, jcfg = tema.EMAConfig(beta=0.995), jema.EMAConfig(beta=0.995)
    net = get_model(TrainConfig(**CONFIGS["non_conservative"]), 10)
    ema = tema.init_ema(net)
    jtree = jema.init_ema(_jax_tree(params_to_jax(ema.state_dict())))
    rng = np.random.default_rng(1)
    for step in range(120):
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
        tema.ema_update(ema, net, step, cfg)
        jtree = jema.ema_update(jtree, _jax_tree(params_to_jax(net.state_dict())), step, jcfg)
        got = params_to_jax(ema.state_dict())
        for path, ref in _leaves(jax.tree_util.tree_map(np.asarray, jtree)):
            if step <= 101:
                np.testing.assert_array_equal(_leaf(got, path), ref)
            else:
                np.testing.assert_allclose(_leaf(got, path), ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- accumulation and chunking
def _ala2_trainer(tmp_path, name, **overrides):
    """The JAX tests' tiny trainer (tests/test_train.py::_tiny_trainer)."""
    fields = dict(mol="alanine_dipeptide_fuberlin", experiment_name=name,
                  hidden_features_gnn=16, num_layers_gnn=1, conservative=False,
                  use_intrinsic_coords=True, use_abs_coords=False, use_distances=False,
                  diffusion_steps=1000, batch_size=32, learning_rate=1e-3, train_iter=10,
                  eval_interval=1000, iterations_on_val=1, log_tensorboard_interval=1000,
                  data_aug=True)
    fields.update(overrides)
    evaluators = fields.pop("evaluators", False)
    dataset = _synthetic_ala2(fields.pop("n_data", 256))
    cfg = TrainConfig(results_folder=str(tmp_path / f"results_{name}"),
                      tensorboard_folder=str(tmp_path / "runs"), data_folder=None, **fields)
    gd = GaussianDiffusion(model=get_model(cfg, 5), num_atoms=5, timesteps=cfg.diffusion_steps,
                           norm_factor=dataset[0].std, loss_weights=cfg.loss_weights)
    return Trainer(gd, dataset, cfg.mol, cfg, use_tensorboard=False, evaluators=evaluators,
                   device=CPU), dataset


def _sgd(trainer, lr):
    trainer.optimizer = torch.optim.SGD(trainer.net.parameters(), lr=lr)
    trainer.lr_schedule = lambda count: lr


def test_gradient_accumulation_matches_manual_grads(tmp_path):
    """accum=k: one SGD(lr=1) update whose step is the mean of the k
    micro-batch gradients, each micro-batch with its own rotation and
    draws, in the order the trainer draws them."""
    trainer, dataset = _ala2_trainer(tmp_path, "accum")
    _sgd(trainer, 1.0)
    data, k = dataset[0].data, 3
    batch = np.stack([data[i * 32: (i + 1) * 32] for i in range(k)])
    params0 = [p.detach().clone() for p in trainer.net.parameters()]

    gen = torch.Generator().manual_seed(7)
    manual = [torch.zeros_like(p) for p in params0]
    losses = []
    for i in range(k):
        mb = rotate(torch.from_numpy(batch[i]), random_rotation_matrices(gen, 32))
        loss, _ = trainer.gd.net_loss(trainer.net, mb, gen)
        for m, g in zip(manual, torch.autograd.grad(loss, list(trainer.net.parameters()))):
            m += g / k
        losses.append(float(loss.detach()))

    metrics = trainer._train_step(batch, torch.Generator().manual_seed(7))
    assert trainer.step == 1
    for p0, p, m in zip(params0, trainer.net.parameters(), manual):
        torch.testing.assert_close(p0 - p.detach(), m, rtol=1e-4, atol=1e-6)
    assert float(metrics["loss"]) == pytest.approx(np.mean(losses), rel=1e-4)


def test_kl_running_max_carried_in_state(tmp_path):
    trainer, dataset = _ala2_trainer(tmp_path, "klmax")
    it = batch_iterator(dataset[0].data, trainer.batch_size, seed=2)
    gen = torch.Generator().manual_seed(11)
    prev_max = 0.0
    for _ in range(5):
        metrics = trainer._train_step(next(it), gen)
        kl, kl_max = float(metrics["kl_at_T"]), float(metrics["kl_max"])
        assert kl_max >= kl and kl_max >= prev_max
        prev_max = kl_max
    assert float(trainer.kl_max) == prev_max <= 1e-4


def test_step_chunking_matches_sequential_steps(tmp_path):
    """K steps through ``_train_chunk`` == K ``_train_step`` calls with the
    same generator: the same weights bit for bit (one Python loop)."""
    a, dataset = _ala2_trainer(tmp_path, "chunk_a")
    b, _ = _ala2_trainer(tmp_path, "chunk_b")
    for t in (a, b):
        _sgd(t, 0.1)
    batches = np.stack([dataset[0].data[i * 32: (i + 1) * 32] for i in range(3)])
    gen_a, gen_b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for i in range(3):
        seq = a._train_step(batches[i], gen_a)
    chunk = b._train_chunk(batches, gen_b)
    assert a.step == b.step == 3
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(seq["loss"], chunk["loss"]) and torch.equal(a.kl_max, b.kl_max)


def test_trainer_chunked_drive_loop(tmp_path):
    trainer, _ = _ala2_trainer(tmp_path, "chunkdrive", steps_per_host_loop=5,
                               num_samples=32, num_samples_final_eval=32, diffusion_steps=100,
                               evaluators=True)
    trainer.train()
    assert trainer.step >= 10
    assert float(trainer.kl_max) <= 1e-4


def test_trainer_chunked_stops_exactly_at_train_iter(tmp_path):
    trainer, _ = _ala2_trainer(tmp_path, "chunkclamp", steps_per_host_loop=4,
                               num_samples=32, num_samples_final_eval=32, diffusion_steps=100,
                               evaluators=True)
    trainer.train()
    assert trainer.step == 10


def test_chunking_rounds_the_eval_interval(tmp_path):
    trainer, _ = _ala2_trainer(tmp_path, "rounding", steps_per_host_loop=6, eval_interval=20)
    assert (trainer.chunk, trainer.eval_interval) == (6, 18)
    trainer, _ = _ala2_trainer(tmp_path, "rounding2", steps_per_host_loop=30, eval_interval=20)
    assert trainer.eval_interval == 30


# ------------------------------------------------------------ end to end
def test_trainer_loss_decreases(tmp_path):
    trainer, dataset = _ala2_trainer(tmp_path, "lossdec", hidden_features_gnn=32,
                                     batch_size=64, learning_rate=2e-3, n_data=1024,
                                     train_iter=150)
    it = batch_iterator(dataset[0].data, trainer.batch_size, seed=1)
    gen = torch.Generator().manual_seed(123)
    losses = [float(trainer._train_step(next(it), gen)["loss"]) for _ in range(150)]
    assert np.mean(losses[-20:]) < np.mean(losses[:20]) * 0.9


def test_trainer_end_to_end_tiny(tmp_path):
    """Two evaluation cycles on synthetic alanine dipeptide with the
    evaluators: checkpoints, config, evaluation results and plots written;
    resume from ``last``. T = 100 diffusion steps keeps the three 1000-step
    ancestral chains of the JAX test to 100 steps each."""
    trainer, dataset = _ala2_trainer(
        tmp_path, "tiny", conservative=True, train_iter=40, eval_interval=20, num_samples=8,
        num_samples_final_eval=8, log_tensorboard_interval=10, loss_weights="higheruntil_10",
        diffusion_steps=100, evaluators=True, profile_steps=2)
    trainer.train()
    rf = trainer.results_folder
    for name in ("model-last.msgpack", "model-best.msgpack", "config.json",
                 "results-final_iid_val.json", "results-final_iid_test.json",
                 "results-1_iid.json", "ramachandran_sampled_final_iid_val.png"):
        assert os.path.exists(os.path.join(rf, name)), name
    assert os.path.exists(os.path.join(trainer.config.tensorboard_folder, "profile", "trace.json"))
    results = json.load(open(os.path.join(rf, "results-final_iid_val.json")))
    assert math.isfinite(results["Dihedral JS"]) and math.isfinite(results["PWD JS"])
    assert int(load_checkpoint(rf, "last")["step"]) == 40
    cfg2 = dataclasses.replace(trainer.config, start_from_last_saved=True, train_iter=44)
    trainer2 = Trainer(trainer.gd, dataset, cfg2.mol, cfg2, use_tensorboard=False,
                       evaluators=False, device=CPU)
    assert trainer2.step == 40
    assert trainer2.best_val_loss == trainer.best_val_loss


def test_alanine_final_eval_saves_no_samples_and_protein_does(tmp_path):
    trainer, _ = _ala2_trainer(tmp_path, "nosave", train_iter=2, num_samples_final_eval=4,
                               diffusion_steps=100)
    trainer.train()
    assert not any(f.startswith("sample-") for f in os.listdir(trainer.results_folder))
    prot = _trainer(tmp_path, dict(CONFIGS["non_conservative"], mol="chignolin", batch_size=8,
                                   train_iter=2, eval_interval=1000, diffusion_steps=100,
                                   num_samples_final_eval=4, log_tensorboard_interval=1),
                    _chignolin_sets())
    prot.train()
    saved = np.load(os.path.join(prot.results_folder, "sample-final_iid.npy"))
    assert saved.shape == (4, 10, 3) and np.isfinite(saved).all()
    with open(os.path.join(prot.results_folder, "sample-final_iid.pdb")) as f:
        assert sum(line.startswith("MODEL") for line in f) == 4


def test_langevin_eval_runs_on_the_plain_path(tmp_path, monkeypatch):
    """``eval_langevin``: LangevinDiffusion with its default force path,
    on the EMA weights, at each noise level."""
    import twoforone_torch.train.trainer as ttrainer

    seen = []

    class Recorder(ttrainer.LangevinDiffusion):
        def __init__(self, gd, params, init, **kw):
            super().__init__(gd, params, init, **kw)
            seen.append((kw["t"], self.force_fn.mode, init.shape))

    monkeypatch.setattr(ttrainer, "LangevinDiffusion", Recorder)
    prot = _trainer(tmp_path, dict(CONFIGS["non_conservative"], mol="chignolin", batch_size=8,
                                   train_iter=1, eval_interval=1000, diffusion_steps=100,
                                   num_samples_final_eval=4, eval_langevin=True,
                                   langevin_timesteps=200, langevin_t_diff=[3, 5]),
                    _chignolin_sets())
    prot.train()
    assert [(t, mode) for t, mode, _ in seen] == [(3, "never"), (5, "never")]
    assert seen[0][2] == (48, 10, 3)
    traj = np.load(os.path.join(prot.results_folder, "sample-final_langevin_tdiff5.npy"))
    assert np.isfinite(traj).all()


# --------------------------------------------------------------- checkpoints
def _jax_written_run(tmp_path, fields, steps=3):
    """A JAX checkpoint as the JAX trainer writes it: optax adamw with the
    trainer's schedule after ``steps`` updates, the JAX EMA, the JAX writer."""
    cfg = TrainConfig(**fields)
    tparams = init_params(get_model(cfg, 10), 4)
    sched = optax.cosine_decay_schedule(cfg.learning_rate, cfg.train_iter,
                                        alpha=cfg.min_lr_cosine_anneal / cfg.learning_rate)
    opt = optax.adamw(learning_rate=sched, weight_decay=cfg.weight_decay)
    params = _jax_tree(tparams)
    opt_state, ema = opt.init(params), jema.init_ema(params)
    rng = np.random.default_rng(2)
    for step in range(steps):
        g = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jema.ema_update(ema, params, step, jema.EMAConfig(beta=cfg.ema_decay))
    state = {"step": steps, "params": params, "ema_params": ema, "opt_state": opt_state,
             "best_val_loss": 0.625}
    return opt, state


def test_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    fields = dict(CONFIGS["non_conservative"], mol="chignolin", experiment_name="x",
                  learning_rate=1e-3, train_iter=10, weight_decay=0.01)
    opt, state = _jax_written_run(tmp_path, fields)
    rf = tmp_path / "results" / "x_"
    jckpt.save_checkpoint(str(rf), "last", state)
    trainer = _trainer(tmp_path, fields, _chignolin_sets(), start_from_last_saved=True)
    assert trainer.step == 3 and trainer.best_val_loss == 0.625
    want = jax.tree_util.tree_map(np.asarray, state)
    for part, module in (("params", trainer.net), ("ema_params", trainer.ema)):
        got = params_to_jax(module.state_dict())
        for path, ref in _leaves(want[part]):
            np.testing.assert_array_equal(_leaf(got, path), ref, err_msg=path)
    saved = trainer._opt_state()
    jsd = serialization.to_state_dict(want["opt_state"])
    assert int(saved["0"]["count"]) == int(jsd["0"]["count"]) == 3
    for moment in ("mu", "nu"):
        for path, ref in _leaves(jsd["0"][moment]):
            np.testing.assert_array_equal(_leaf(saved["0"][moment], path), ref, err_msg=path)
    # One more update from the resumed state, with the same gradients.
    grads = {n: np.full(p.shape, 0.05, np.float32) for n, p in trainer.net.named_parameters()}
    trainer._update([torch.from_numpy(g) for g in grads.values()])
    jgrads = _jax_tree(params_to_jax({n: torch.from_numpy(g) for n, g in grads.items()}))
    updates, _ = opt.update(jgrads, state["opt_state"], state["params"])
    jparams = jax.tree_util.tree_map(np.asarray, optax.apply_updates(state["params"], updates))
    got = params_to_jax(trainer.net.state_dict())
    for path, ref in _leaves(jparams):
        assert np.abs(_leaf(got, path) - ref).max() <= 1e-6 * np.abs(ref).max(), path


def test_port_written_checkpoint_loads_under_the_jax_template(tmp_path):
    fields = dict(CONFIGS["non_conservative"], mol="chignolin", experiment_name="p",
                  learning_rate=1e-3, train_iter=10, batch_size=16)
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    it = batch_iterator(trainer.train_data.data, 16, seed=0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        trainer._train_step(next(it), gen)
    trainer.best_val_loss = 0.75
    trainer.save(1, save_best=True)

    opt, jstate = _jax_written_run(tmp_path, fields, steps=0)
    template = {"step": 0, "params": jstate["params"], "ema_params": jstate["ema_params"],
                "opt_state": jstate["opt_state"], "best_val_loss": 0.0}
    for name in ("last", "best"):
        restored = jckpt.load_checkpoint(trainer.results_folder, name, template)
        assert int(restored["step"]) == 3 and float(restored["best_val_loss"]) == 0.75
        assert type(restored["opt_state"]) is type(jstate["opt_state"])
        ours = read_checkpoint(os.path.join(trainer.results_folder, f"model-{name}.msgpack"))
        assert ours["opt_state"]["0"]["count"].dtype == np.int32
        mine = {"params": params_to_jax(trainer.net.state_dict()),
                "ema_params": trainer.ema_params(),
                "mu": trainer._opt_state()["0"]["mu"], "nu": trainer._opt_state()["0"]["nu"]}
        theirs = {"params": restored["params"], "ema_params": restored["ema_params"],
                  "mu": restored["opt_state"][0].mu, "nu": restored["opt_state"][0].nu}
        for part in mine:
            for path, ref in _leaves(jax.tree_util.tree_map(np.asarray, theirs[part])):
                np.testing.assert_array_equal(_leaf(mine[part], path), ref, err_msg=path)
        assert int(restored["opt_state"][0].count) == int(restored["opt_state"][2].count) == 3
    with open(os.path.join(trainer.results_folder, "model-last.msgpack"), "rb") as f:
        flax_tree = serialization.msgpack_restore(f.read())
    assert set(flax_tree) == {"step", "params", "ema_params", "opt_state", "best_val_loss"}
    assert json.load(open(os.path.join(trainer.results_folder, "config.json")))["mol"] == "chignolin"


def test_port_written_best_scores_the_same_in_both_packages(tmp_path):
    """A port-written model-best.msgpack read by each package's own loader:
    the same score at the same points (1e-5 of the largest)."""
    from twoforone_torch.cli.sample import load_model

    fields = dict(CHAIN10, experiment_name="b", batch_size=16, train_iter=10)
    trainer = _trainer(tmp_path, fields, _chignolin_sets())
    trainer.ema.load_state_dict(params_from_jax(load_ema_params("chain10")))
    trainer.save(1, save_best=True)
    gd, ema_params, _, _ = load_model(trainer.results_folder, "best", device=CPU)
    jparams = jckpt.load_checkpoint(trainer.results_folder, "best")["ema_params"]
    jgd = JGD(model=jget_model(JConfig.from_dict(CHAIN10), 10), num_atoms=10)
    x = chain10_dataset(8, seed=9) / 4.0
    t = np.linspace(0.01, 0.9, 8).astype(np.float32)
    ref = np.asarray(jgd.score_fn(_jax_tree(jparams))(jnp.asarray(x), jnp.asarray(t)))
    got = gd.score_fn(ema_params, CPU)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_trainer_rejects_a_mesh(tmp_path):
    """A mesh that is not a ``Mesh``, or one that places the rank on another
    device than ``device``, is refused before anything is built."""
    from twoforone_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="Mesh"):
        Trainer(None, _chignolin_sets(), "chignolin", TrainConfig(), mesh=object(), device=CPU)
    on_card = Mesh(1, 0, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="places this rank on cuda:0"):
        Trainer(None, _chignolin_sets(), "chignolin", TrainConfig(), mesh=on_card, device=CPU)


# ------------------------------------------------------------------- preempt
def test_preempt_is_a_no_op_without_the_flag(tmp_path, monkeypatch):
    monkeypatch.delenv("TWOFORONE_PREEMPT_FLAG", raising=False)
    exit_if_preempted("anywhere")
    flag = tmp_path / "WAITING"
    monkeypatch.setenv("TWOFORONE_PREEMPT_FLAG", str(flag))
    exit_if_preempted("flag path set, file absent")
    flag.touch()
    with pytest.raises(SystemExit) as e:
        exit_if_preempted("milestone 1")
    assert e.value.code == EXIT_PREEMPTED == 75
