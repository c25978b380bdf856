"""Training runtime for the CG diffusion model (port of
``twoforone_tpu/train/trainer.py``, the same constructor and cadence).

- The network is an ``nn.Module`` whose parameters the optimizer holds:
  :class:`AdamW`, optax's ``adamw`` (beta 0.9 / 0.999, eps 1e-8 outside
  the square root, weight decay decoupled and taken from the pre-update
  weights) in optax's float32 arithmetic, with optax's cosine schedule
  evaluated at the update count *before* the update; the EMA is a second
  module (:mod:`twoforone_torch.train.ema`).
- A step: each micro-batch gets its own SO(3) rotation, timesteps and
  noise, all drawn from one ``torch.Generator`` on the run's device; the
  gradients of the micro-batch losses are averaged; one optimizer update;
  the EMA update at the step count before the increment. The force is the
  plain network's -dE/dx with its graph kept (``score_forward(...,
  create_graph=True)``); no kernel runs in a training step, as in the JAX
  package.
- On the card a step replays CUDA graphs, the counterpart of the JAX
  package's jitted step (:mod:`twoforone_torch.utils.cuda_graph`): one of
  the gradient half (rotation, loss, double backward, summed over the
  micro-batches) and one of the update half (KL max, AdamW, EMA; one
  variant for the steps that update the EMA, one for those that skip it).
  The draws, the batch and each update's numbers (learning rate, bias
  corrections, EMA decay) go into static buffers and device scalars
  before the replays; a mesh's collectives run between the halves; the
  host keeps the counts. The batch is written into a pinned host slot of
  a :class:`StagingRing` and copied from there into its static buffer
  without a synchronisation, so the host enqueues the next step while the
  device runs this one, up to ``STAGING_DEPTH`` batches ahead. The eager
  step runs the same functions, so both give the same bits; the CPU runs
  it. ``eval_loss`` replays one captured batch the same way.
- Each step's host phases are spans (:mod:`twoforone_torch.utils.profiling`):
  ``trainer.batch`` (a wait there is the staging ring's bound on running
  ahead), ``trainer.draws``, ``trainer.gradients`` and
  ``trainer.update``. ``profile_steps`` = K writes a Chrome trace of K steps
  from step 10 to ``tensorboard_folder/profile/trace.json`` through
  ``profiling.trace``.
- ``steps_per_host_loop`` = K runs K steps, each replayed on its own (the
  JAX package scans them in one program), with the same rounding of the
  evaluation interval and the same clamp of the last chunk.
- The KL-at-T invariant is a running max on the device, asserted at every
  log point; evaluation on the EMA weights; best / last / milestone
  checkpoints in the JAX package's msgpack tree (weights in the flax
  layout, the optimizer state in optax's), so either package resumes a run
  the other wrote; early stop after 10 evaluations without gain; the final
  i.i.d. (and optional Langevin) evaluation.
- Data parallelism over a ``mesh`` (:mod:`twoforone_torch.parallel.mesh`,
  one process per GPU): ``batch_size`` is global, rounded down to a
  multiple of the mesh size, and each rank draws ``batch_size / size``
  rows from its own iterator (seed + 7919 x rank). The weights and the EMA
  start as rank 0's. Each micro-batch's rotation, timesteps and noise are
  drawn for the global batch from the run's generator, which every rank
  seeds alike, and each rank keeps its rows. After the backward pass the
  gradient is all-reduced as one flat buffer (sum over the ranks, then
  divided by their number): the mean over the global batch. The logged
  loss and ``eval_loss`` are means over the ranks; ``sample`` gathers, so
  every rank scores the same samples; every rank writes its checkpoints,
  as in the JAX package. ``DistributedDataParallel`` is not used: the loss
  holds an input gradient taken with ``create_graph=True``, and DDP's
  reducer is not built for the double backward.
- Products run in float32 (TF32 off) and the caller's setting comes back.
- Batches come from the numpy iterator :func:`batch_iterator`, the JAX
  package's, so both packages see the same batches for the same seed and
  rank.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import time
from functools import partial

import numpy as np
import torch

from twoforone_torch.core.diffusion import GaussianDiffusion, sample_timesteps
from twoforone_torch.data.molecules import MASS_ALA2, MASS_FASTFOLDER, temp_dict
from twoforone_torch.dynamics.langevin import LangevinDiffusion
from twoforone_torch.evaluate.evaluators import Evaluator, sample_from_model
from twoforone_torch.models.graph_transformer import init_params, score_forward
from twoforone_torch.ops.geometry import random_rotation_matrices, rotate
from twoforone_torch.parallel.mesh import (
    all_reduce_,
    entry_device,
    gather,
    local_rows,
    mesh_size,
    replicate,
    shard_batch,
)
from twoforone_torch.train.ema import EMAConfig, ema_apply, ema_due, ema_scalars, init_ema
from twoforone_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from twoforone_torch.utils.convert import params_from_jax, params_to_jax
from twoforone_torch.utils.cuda_graph import graphs_for, output, run, static
from twoforone_torch.utils.device import float32_products
from twoforone_torch.utils.preempt import exit_if_preempted
from twoforone_torch.utils.profiling import annotate, trace


def batch_iterator(data: np.ndarray, batch_size: int, seed: int = 0):
    """Infinite shuffled batches, drop_last=True."""
    rng = np.random.default_rng(seed)
    n = len(data)
    assert n >= batch_size, "dataset smaller than batch size"
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield data[perm[i : i + batch_size]]


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule`` in float32: the learning rate at
    update count ``count`` (0 for the first update)."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * ((f32(1.0) - f32(alpha)) * cosine + f32(alpha)))

    return schedule


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` as a torch optimizer, in optax's float32 arithmetic:

        mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   count += 1
        u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p  = p - lr (u + weight_decay p)

    with the bias corrections' powers taken in float32 as optax takes them
    (``torch.optim.AdamW`` takes them in float64, which moves a first step
    by ~6e-6 of itself), the weight decay from the pre-update weights, and
    one update count per parameter group (``group["count"]``, optax's
    ``count``). ``group["lr"]`` is the rate of this update.

    An update is two halves: :meth:`advance` on the host (the count, the
    moments' creation, and the numbers that change every update, ``-lr``
    and the reciprocals of the two bias corrections, into 0-d device
    tensors of the group, ``group["device_scalars"]``) and :meth:`apply` on
    the device, which reads only tensors, so that a training step's CUDA
    graph records it once for every update. :meth:`step` runs both.

    The moments are multiplied by the float32 reciprocal of each bias
    correction, which is what dividing them by a Python number does on the
    card (ATen takes a host scalar's reciprocal; dividing by a device
    tensor divides), so the update keeps the bits of the eager update that
    divided by Python numbers; optax divides, a last-bit difference.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, count=0))
        for group in self.param_groups:
            device = group["params"][0].device
            group["device_scalars"] = tuple(torch.zeros((), device=device) for _ in range(3))

    @staticmethod
    def _live(group):
        return [p for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def step(self, closure=None):
        self.advance()
        self.apply()

    def advance(self):
        """The host half of an update: count it, create the moments of a
        parameter's first update, and fill ``-lr``, ``1 / (1 - b1^count)``
        and ``1 / (1 - b2^count)`` (host float32) into the group's device
        scalars."""
        f32 = np.float32
        for group in self.param_groups:
            params = self._live(group)
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            group["count"] += 1
            neg_lr, inv_bc1, inv_bc2 = group["device_scalars"]
            neg_lr.fill_(-float(f32(group["lr"])))
            for inv, b in ((inv_bc1, group["b1"]), (inv_bc2, group["b2"])):
                inv.fill_(float(f32(1.0) / (f32(1.0) - f32(b) ** f32(group["count"]))))

    @torch.no_grad()
    def apply(self):
        """The device half of an update, on the numbers :meth:`advance` filled."""
        for group in self.param_groups:
            params = self._live(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            neg_lr, inv_bc1, inv_bc2 = group["device_scalars"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                       1.0 - b2))
            denom = torch._foreach_sqrt(torch._foreach_mul(nu, inv_bc2))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(torch._foreach_mul(mu, inv_bc1), denom)
            torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(update, neg_lr)
            torch._foreach_add_(params, update)


def make_optimizer(net: torch.nn.Module, config):
    """``(AdamW over net's parameters, schedule(count) -> lr)``: optax's
    ``adamw`` with the JAX trainer's numbers and the cosine anneal to
    ``min_lr_cosine_anneal`` over ``train_iter`` updates (a constant rate
    when that is None)."""
    if config.min_lr_cosine_anneal is not None:
        schedule = cosine_decay_schedule(config.learning_rate, config.train_iter,
                                         config.min_lr_cosine_anneal / config.learning_rate)
    else:
        schedule = lambda count: float(config.learning_rate)  # noqa: E731
    return AdamW(net.parameters(), lr=schedule(0), weight_decay=config.weight_decay), schedule


# Slots of a staging ring: the host runs at most this many batches ahead.
STAGING_DEPTH = 2


class StagingRing:
    """Pinned host slots through which a host batch reaches a device
    tensor without a stream synchronisation (a pageable copy waits for the
    stream to drain).

    ``ring(batch, out)`` writes the host array ``batch`` into the next of
    ``STAGING_DEPTH`` slots kept for ``out``'s shape and dtype (a synchronous host
    copy: the caller may reuse its array as soon as the call returns),
    copies that slot into ``out`` with a non-blocking copy on the current
    stream of ``out``'s device, and records the slot's event after it. A
    slot is written again only once its event reports that copy done: the
    one place the host waits, which bounds how far it runs ahead of the
    device (``STAGING_DEPTH`` batches) and keeps a copy in flight from reading a
    rewritten slot. Slots are pinned where ``out`` is on a CUDA device.
    ``event`` makes a slot's event (``record(stream)``, ``query()``,
    ``synchronize()``).

    Counters, process-wide like ``StepGraphs.captures``: ``staged`` counts
    the batches copied through a ring, ``waits`` the slot reuses that found
    the slot's copy still in flight.
    """

    staged = 0
    waits = 0

    def __init__(self, event=torch.cuda.Event):
        self._event = event
        self.slots = {}  # (shape, dtype) -> [(host tensor, event)] * STAGING_DEPTH
        self._turn = {}

    def __call__(self, batch, out: torch.Tensor) -> torch.Tensor:
        key = (tuple(out.shape), out.dtype)
        if key not in self.slots:
            self.slots[key] = [(torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda),
                                self._event()) for _ in range(STAGING_DEPTH)]
            self._turn[key] = 0
        i = self._turn[key]
        self._turn[key] = (i + 1) % STAGING_DEPTH
        host, event = self.slots[key][i]
        if not event.query():
            StagingRing.waits += 1
            event.synchronize()
        host.copy_(torch.as_tensor(batch).reshape(host.shape))
        out.copy_(host, non_blocking=True)
        event.record(torch.cuda.current_stream(out.device) if out.is_cuda else None)
        StagingRing.staged += 1
        return out


class Trainer:
    """Trainer for the CG diffusion model. See TrainConfig for options."""

    def __init__(
        self,
        diffusion_model: GaussianDiffusion,
        dataset,  # (train, val, test) CGDatasets
        mol_name: str,
        config,
        mesh=None,
        use_tensorboard: bool = True,
        evaluators: bool = True,
        device="cuda",
    ):
        # ``evaluators=False`` skips the per-molecule Evaluator (golden TIC /
        # PWD / dihedral scoring) and keeps the loss evaluation, the
        # checkpoints and the sample export.
        self.device = entry_device(device, mesh)
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.gd = diffusion_model
        self.config = config
        self.mol_name = mol_name
        self.train_data, self.val_data, self.test_data = dataset
        n_ranks = mesh_size(mesh)
        self.batch_size = config.batch_size - (config.batch_size % n_ranks)
        self.local_batch = self.batch_size // n_ranks
        self.grad_accum = max(1, int(getattr(config, "gradient_accumulate_every", 1) or 1))
        self.train_num_steps = config.train_iter
        self.eval_interval = config.eval_interval
        self.log_interval = max(1, config.log_tensorboard_interval)
        # K optimizer steps per chunk; the evaluation cadence rounds to
        # chunk boundaries, as in the JAX package.
        self.chunk = max(1, int(getattr(config, "steps_per_host_loop", 1) or 1))
        if self.chunk > 1:
            self.eval_interval = max(self.chunk, (self.eval_interval // self.chunk) * self.chunk)

        self.net = copy.deepcopy(diffusion_model.model).to(self.device)
        self.net.load_state_dict(params_from_jax(init_params(diffusion_model.model, config.seed)))
        replicate(self.net, mesh)
        self.ema = init_ema(self.net)
        # The CUDA graphs of the card, each captured once: the training step's
        # two halves, the loss evaluation, and sample()'s reverse step. The
        # weights, the EMA, Adam's moments and the KL max they read are
        # updated and loaded in place. None (the CPU) runs them eagerly.
        self._step_graphs = graphs_for(self.device)
        self._eval_graphs = graphs_for(self.device)
        self._sample_graphs = graphs_for(self.device)
        # The graphed step's batch comes through pinned slots on the card.
        self._staging = StagingRing() if self.device.type == "cuda" else None
        self.optimizer, self.lr_schedule = make_optimizer(self.net, config)
        self.ema_cfg = EMAConfig(beta=config.ema_decay)
        self._ema_scalars = ema_scalars(self.device)

        exp = config.experiment_name + ("_" if config.experiment_name else "")
        self.results_folder = os.path.join(config.results_folder, exp)
        os.makedirs(self.results_folder, exist_ok=True)
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(config.tensorboard_folder, exp + "_trn"))
            except ImportError:
                pass

        self.evaluator_val = self.evaluator_test = None
        if evaluators:
            self.evaluator_val, self.evaluator_test = (
                Evaluator(part, self.train_data.topology, mol_name=mol_name,
                          eval_folder=self.results_folder, data_folder=config.data_folder)
                for part in (self.val_data, self.test_data)
            )

        self.step = 0
        self.kl_max = torch.zeros((), device=self.device)
        self.best_val_loss = math.inf

        if config.start_from_last_saved:
            if checkpoint_exists(self.results_folder, "last"):
                self.load("last")
                print("Settings loaded from last checkpoint")
            else:
                print("Not last checkpoint available to load.")

    # ------------------------------------------------------------- one step
    def _draws(self, generator: torch.Generator, local: int, rotation: bool, given=None):
        """This rank's rows of one micro-batch's draws for the global batch
        (``local`` rows a rank): the rotation (when ``rotation``), then t,
        then the noise, each drawn from ``generator`` unless ``given``
        holds it (for the global batch, as another implementation drew it).
        """
        given = given or {}
        b = local * mesh_size(self.mesh)
        rows = local_rows(b, self.mesh)
        out = {}
        if rotation:
            rot = given.get("rotation")
            if rot is None:
                rot = random_rotation_matrices(generator, b)
            out["rotation"] = torch.as_tensor(rot, dtype=torch.float32, device=self.device)[rows]
        t = given.get("t")
        if t is None:
            t = sample_timesteps(self.gd.buffers_on(self.device), generator, b,
                                 self.gd.t_diff_interval, self.device)
        noise = given.get("noise")
        if noise is None:
            noise = torch.randn((b, self.gd.num_atoms, 3), generator=generator,
                                dtype=torch.float32, device=self.device)
        out["t"] = torch.as_tensor(t, dtype=torch.long, device=self.device)[rows]
        out["noise"] = torch.as_tensor(noise, dtype=torch.float32, device=self.device)[rows]
        return out

    def _train_step(self, batch, generator: torch.Generator, draws=None) -> dict:
        """One optimizer step. ``batch`` is this rank's (B, N, 3) or
        (accum, B, N, 3): the gradients of ``loss/accum`` are summed over the
        micro-batches, each rotated on its own, then averaged over the
        ranks, before the one update.

        ``draws`` (tests): one dict per micro-batch with the ``rotation``
        (B, 3, 3), ``t`` (B,) and ``noise`` (B, N, 3) of the global batch
        that another implementation drew; what is missing is drawn from
        ``generator``. Returns the step's metrics as new device tensors, over
        the global batch: ``loss``, ``kl_at_T``, ``kl_max``.

        On the card the step replays two captured halves (the counterpart
        of the JAX package's jitted step): the gradients, then the update.
        The draws, the batch and the update's numbers are filled into static
        buffers and device scalars before the replays, and a mesh's
        collectives run between the halves. The batch goes through the
        trainer's :class:`StagingRing`: the step waits for the device only
        where the ring's next slot is still being copied from. On the CPU
        both run eagerly; both forms run the same functions, so they give
        the same bits.
        """
        graphs = self._step_graphs
        with float32_products():
            with annotate("trainer.batch"):
                if graphs is not None and self._staging is not None:
                    shape = tuple(np.shape(batch))
                    batch = self._staging(batch, graphs.buffer(
                        "batch", shape if len(shape) == 4 else (1, *shape)))
                else:
                    batch = shard_batch(batch, self.mesh, self.device)
                    if batch.ndim == 3:
                        batch = batch[None]
                    batch = static(graphs, "batch", batch)
            with annotate("trainer.draws"):
                drawn = [self._draws(generator, batch.shape[1], self.config.data_aug,
                                     None if draws is None else draws[i])
                         for i in range(batch.shape[0])]
                drawn = [{k: static(graphs, (k, i), v) for k, v in d.items()}
                         for i, d in enumerate(drawn)]
            with annotate("trainer.gradients"):
                params = list(self.net.parameters())
                grads = [output(graphs, ("grad", i), p) for i, p in enumerate(params)]
                loss, kl = (output(graphs, name, self.kl_max) for name in ("loss", "kl"))
                run(graphs, ("gradients", tuple(batch.shape)),
                     partial(self._gradients, grads, loss, kl, batch, drawn))
                all_reduce_(kl, self.mesh, "max")
                if self.mesh is not None:
                    # One flat buffer, one collective: the mean over the global batch.
                    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
                    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                        g.copy_(f.view_as(g))
                all_reduce_(loss, self.mesh)
                for p, g in zip(params, grads):
                    p.grad = g
            self._apply_update(kl, graphs)
        return {"loss": loss.clone(), "kl_at_T": kl.clone(), "kl_max": self.kl_max.clone()}

    def _gradients(self, grads, loss_out, kl_out, batch, draws) -> None:
        """The gradient half of a step, device work only (run eagerly, or
        recorded in the step's graph): for each micro-batch its rotation,
        ``net_loss`` with the force's graph kept and the gradient of the
        loss, summed into ``grads``, then divided by the micro-batch count;
        the mean loss into ``loss_out`` and the largest KL-at-T into
        ``kl_out``. Unused parameters keep a zero gradient."""
        params = list(self.net.parameters())
        torch._foreach_zero_(grads)
        losses, kls = [], []
        for mb, d in zip(batch, draws):
            if self.config.data_aug:
                mb = rotate(mb, d["rotation"])
            loss, aux = self.gd.net_loss(self.net, mb, t=d["t"], noise=d["noise"])
            if loss.requires_grad:  # not so for an energy that ignores x
                for g, gi in zip(grads, torch.autograd.grad(loss, params, allow_unused=True)):
                    if gi is not None:
                        g.add_(gi)
            losses.append(loss.detach())
            kls.append(aux["kl_at_T"])
        accum = len(losses)
        if accum > 1:
            for g in grads:
                g.div_(accum)
        loss_out.copy_(losses[0] if accum == 1 else torch.stack(losses).sum() / accum)
        kl_out.copy_(torch.stack(kls).max())

    def _update(self, grads) -> None:
        """One optimizer update with ``grads`` (one tensor per parameter, in
        ``net.parameters()`` order; left in ``.grad``), the learning rate of
        the schedule at the update count before it, then the EMA update at
        that count, then the count's increment."""
        for p, g in zip(self.net.parameters(), grads):
            p.grad = torch.as_tensor(g, dtype=torch.float32, device=self.device)
        self._apply_update(None, None)

    def _apply_update(self, kl, graphs) -> None:
        """The update half of a step. The host decides this update's numbers
        (the learning rate at the count before it, Adam's count and bias
        corrections, whether the EMA updates and its decay) and fills them
        into device scalars; then :meth:`_update_work` runs, eagerly or
        replayed from ``graphs`` (one graph for the steps that update the
        EMA, one for those that skip it); then the count's increment."""
        with annotate("trainer.update"):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.step)
            ema_now = ema_due(self.step, self.ema_cfg, self._ema_scalars)
            self.optimizer.advance()
            run(graphs, ("update", ema_now),
                partial(self._update_work, kl, ema_now, self.optimizer.apply))
        self.step += 1

    def _update_work(self, kl, ema_now: bool, optimizer_step) -> None:
        """The device work of an update: the running KL max in place, the
        optimizer's update, the EMA's when ``ema_now``."""
        if kl is not None:
            torch.maximum(self.kl_max, kl, out=self.kl_max)
        optimizer_step()
        if ema_now:
            ema_apply(self.ema, self.net, self._ema_scalars)

    def _train_chunk(self, batches, generator: torch.Generator, draws=None) -> dict:
        """K optimizer steps (``batches``: (K, B, N, 3) or (K, accum, B, N, 3)),
        the counterpart of the JAX package's scanned chunk: K calls of
        :meth:`_train_step`, each filling its draws and batch before its
        replays on the card. Returns the last step's metrics (``kl_max``
        covers every step)."""
        for k in range(len(batches)):
            metrics = self._train_step(batches[k], generator,
                                       None if draws is None else draws[k])
        return metrics

    # ---------------------------------------------------------------- driving
    def eval_loss(self, data: np.ndarray, val_iters: int, generator: torch.Generator,
                  partition_name: str = "val") -> float:
        """Mean loss of the EMA weights over ``val_iters`` batches of ``data``
        (global batches: each rank draws its rows, and the mean is taken
        over the ranks). On the card each batch replays one captured
        evaluation, with the batch, t and the noise in static buffers and
        the total kept on the device."""
        print(f"val iters {val_iters}")
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
        it = batch_iterator(data, self.local_batch, seed=(seed + 7919 * self.rank) % 2**31)
        graphs = self._eval_graphs
        total = output(graphs, "total", self.kl_max).zero_()
        with float32_products(), torch.no_grad():
            for _ in range(val_iters):
                mb = shard_batch(next(it), self.mesh, self.device)
                d = self._draws(generator, mb.shape[0], rotation=False)
                inputs = [static(graphs, name, v) for name, v in
                          (("batch", mb), ("t", d["t"]), ("noise", d["noise"]))]
                run(graphs, ("eval", tuple(mb.shape)), partial(self._eval_batch, total, *inputs))
        loss = float(all_reduce_(total, self.mesh)) / max(1, val_iters)
        if self.writer is not None:
            self.writer.add_scalar(f"Loss {partition_name}", loss, int(self.step))
        print(f"Loss {partition_name} \t {loss}")
        return loss

    def _eval_batch(self, total, mb, t, noise) -> None:
        """The EMA weights' loss on one batch, added to ``total`` (device work
        only)."""
        loss, _ = self.gd.net_loss(self.ema, mb, t=t, noise=noise, create_graph=False)
        total.add_(loss)

    def sample(self, num_samples: int, generator: torch.Generator = None) -> np.ndarray:
        """Sample from the EMA weights with the plain network's full
        ancestral chain, in batches of the training batch size, truncated to
        ``num_samples``: (num_samples, N, 3) numpy, the same on every rank
        (each rank computes its rows of a batch, then they are gathered).
        On the card the batches replay one captured reverse step, as the
        sampling closures do (the same bits as the eager chain)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)

        def score_fn(x, t_norm):
            return score_forward(self.ema, x, t_norm)

        def fn(b, gen):
            with float32_products():
                mol = self.gd.reverse_chain(self._sample_graphs, score_fn,
                                            (b, self.gd.num_atoms, 3), gen, device=self.device,
                                            mesh=self.mesh)
            return gather(mol * self.gd.norm_factor, self.mesh)

        return sample_from_model(fn, num_samples, self.batch_size, generator)

    def ema_params(self) -> dict:
        """The EMA weights as the flax parameter tree (numpy)."""
        return params_to_jax(self.ema.state_dict())

    def _opt_state(self) -> dict:
        """The optimizer state in the layout ``flax.serialization.to_state_dict``
        gives optax's ``adamw`` state: (scale_by_adam {count, mu, nu},
        add_decayed_weights {}, the schedule's {count} or {})."""
        mu, nu = {}, {}
        for name, p in self.net.named_parameters():
            st = self.optimizer.state.get(p, {})
            mu[name] = st.get("mu", torch.zeros_like(p))
            nu[name] = st.get("nu", torch.zeros_like(p))
        count = np.asarray(self.optimizer.param_groups[0]["count"], dtype=np.int32)
        sched = {} if self.config.min_lr_cosine_anneal is None else {"count": count.copy()}
        return {"0": {"count": count, "mu": params_to_jax(mu), "nu": params_to_jax(nu)},
                "1": {}, "2": sched}

    def _load_opt_state(self, opt_state: dict) -> None:
        adam = opt_state["0"]
        mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
        self.optimizer.param_groups[0]["count"] = int(np.asarray(adam["count"]))
        # Into the moments that exist: a captured update reads those tensors.
        for name, p in self.net.named_parameters():
            st = self.optimizer.state[p]
            for k, v in (("mu", mu[name]), ("nu", nu[name])):
                if k in st:
                    st[k].copy_(v)
                else:
                    st[k] = v.to(self.device)

    def save(self, milestone, save_best: bool = False):
        state = {
            "step": int(self.step),
            "params": params_to_jax(self.net.state_dict()),
            "ema_params": self.ema_params(),
            "opt_state": self._opt_state(),
            "best_val_loss": float(self.best_val_loss),
        }
        if self.config.save_all_checkpoints:
            save_checkpoint(self.results_folder, str(milestone), state)
        save_checkpoint(self.results_folder, "last", state)
        if save_best:
            save_checkpoint(self.results_folder, "best", state)
        self.config.to_json(os.path.join(self.results_folder, "config.json"))

    def load(self, milestone: str = "last"):
        state = load_checkpoint(self.results_folder, str(milestone))
        self.best_val_loss = float(state["best_val_loss"])
        self.net.load_state_dict(params_from_jax(state["params"]))
        self.ema.load_state_dict(params_from_jax(state["ema_params"]))
        self._load_opt_state(state["opt_state"])
        self.step = int(state["step"])
        self.kl_max.zero_()

    def train(self):
        cfg = self.config
        generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        data = np.asarray(self.train_data.data)
        it = batch_iterator(data, self.local_batch, seed=cfg.seed + 7919 * self.rank)
        val_iters = max(1, int(cfg.iterations_on_val
                               * max(1, len(self.val_data) // self.batch_size)))

        def draw():
            if self.grad_accum == 1:
                return next(it)
            return np.stack([next(it) for _ in range(self.grad_accum)])

        early_stopping_counter = 0
        step = self.step
        t_start = time.time()
        profiler, profiled = None, False
        while step < self.train_num_steps:
            if getattr(cfg, "profile_steps", 0) > 0:
                # Trace a window of steady-state steps (after the warm-up).
                if step >= 10 and profiler is None and not profiled:
                    profiler = contextlib.ExitStack()
                    profiler.enter_context(trace(os.path.join(cfg.tensorboard_folder, "profile")))
                elif profiler is not None and step >= 10 + cfg.profile_steps:
                    profiler.close()
                    profiler, profiled = None, True
            # The last chunk is clamped so that training stops exactly at
            # train_num_steps.
            chunk = min(self.chunk, self.train_num_steps - step)
            if chunk > 1:
                metrics = self._train_chunk(np.stack([draw() for _ in range(chunk)]), generator)
            else:
                metrics = self._train_step(draw(), generator)
            step += chunk

            if step % self.log_interval < chunk or step >= self.train_num_steps:
                loss = float(metrics["loss"])
                # Running max over every step since the start: a larger log
                # interval skips no step's KL-at-T check.
                kl = float(metrics["kl_max"])
                assert kl <= 1e-4, f"Normal KL check at T failed, max value: {kl}"
                if self.writer is not None:
                    self.writer.add_scalar("Loss", loss, step)
                if step % (self.log_interval * 100) < chunk or step <= self.log_interval:
                    rate = step / max(time.time() - t_start, 1e-9)
                    print(f"step {step}/{self.train_num_steps} loss {loss:.4f} ({rate:.1f} it/s)")

            if step != 0 and step % self.eval_interval == 0:
                milestone = step // self.eval_interval
                val_loss = self.eval_loss(np.asarray(self.val_data.data), val_iters, generator)
                # Samples only where an evaluator reads them.
                if self.evaluator_val is not None:
                    sampled_mol = self.sample(cfg.num_samples, generator)
                    results = self.evaluator_val.eval(
                        sampled_mol, milestone=f"{milestone}_iid", save_plots=True
                    )
                    if self.writer is not None:
                        for k, v in results.items():
                            self.writer.add_scalar(k, v, step)

                new_best = val_loss < self.best_val_loss
                self.best_val_loss = val_loss if new_best else self.best_val_loss
                self.save(milestone, save_best=new_best)
                # A milestone just persisted is a lossless pause point.
                exit_if_preempted(f"train milestone {milestone} (step {step})")
                early_stopping_counter = 0 if new_best else early_stopping_counter + 1
                if early_stopping_counter > 9:
                    break
        if profiler is not None:
            profiler.close()

        self.final_eval(generator)
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
        print("Training complete")

    # ------------------------------------------------------------ final eval
    def final_eval(self, generator: torch.Generator):
        cfg = self.config
        print("\nFinal and larger evaluation")
        if cfg.pick_checkpoint == "best" and checkpoint_exists(self.results_folder, "best"):
            self.load("best")

        sampled_mol = self.sample(cfg.num_samples_final_eval, generator)
        if "alanine" not in self.mol_name:
            self._save_samples(sampled_mol, "final_iid")

        if self.evaluator_val is not None:
            results_val = self.evaluator_val.eval(
                sampled_mol, milestone="final_iid_val", save_plots=True
            )
            results_test = self.evaluator_test.eval(
                sampled_mol, milestone="final_iid_test", save_plots=False
            )
            if self.writer is not None:
                for k, v in results_val.items():
                    self.writer.add_scalar(k + "_FINAL_iid_val", v)
                for k, v in results_test.items():
                    self.writer.add_scalar(k + "_FINAL_iid_test", v)

        if cfg.eval_langevin:
            self._langevin_eval()

    def _langevin_eval(self):
        """Post-training Langevin evaluation: chains start from 100 training
        frames, run at each configured noise level on the plain network
        (``LangevinDiffusion``'s default ``fused="never"``), and the
        trajectory goes through the evaluators."""
        cfg = self.config
        temp_data = temp_dict[self.mol_name.upper()]
        rng = np.random.default_rng(0)
        idx = rng.permutation(len(self.train_data))[:100]
        init_mol = np.asarray(self.train_data.data[idx])
        is_ala = "alanine".upper() in self.mol_name.upper()
        mass = MASS_ALA2 if is_ala else MASS_FASTFOLDER
        save_interval = 250 if is_ala else 200

        for t_diff in cfg.langevin_t_diff:
            with float32_products():
                sampler = LangevinDiffusion(
                    self.gd,
                    self.ema_params(),
                    init_mol,
                    n_timesteps=cfg.langevin_timesteps,
                    save_interval=save_interval,
                    t=t_diff,
                    temp_data=temp_data,
                    temp_sim=temp_data,
                    dt=cfg.langevin_stepsize,
                    masses=[mass] * self.train_data.num_beads,
                    device=self.device,
                )
                sampled_mol = sampler.sample()
            if "alanine" not in self.mol_name:
                self._save_samples(sampled_mol, f"final_langevin_tdiff{t_diff}")
            for evalname, evaluator, plots in (
                ("val", self.evaluator_val, True),
                ("test", self.evaluator_test, False),
            ):
                if evaluator is None:
                    continue
                results = evaluator.eval(
                    sampled_mol,
                    milestone=f"final_langevin_tdiff{t_diff}_{evalname}",
                    save_plots=plots,
                )
                if self.writer is not None:
                    for k, v in results.items():
                        self.writer.add_scalar(k + f"_FINAL_langevin_t{t_diff}_{evalname}", v)

    def _save_samples(self, sampled_mol: np.ndarray, milestone: str):
        """Save samples as .npy plus a 100-frame PDB (rank 0 only: every
        rank holds the same samples)."""
        from twoforone_torch.data.pdb import save_pdb

        if self.rank != 0:
            return

        np.save(os.path.join(self.results_folder, f"sample-{milestone}.npy"), sampled_mol)
        save_pdb(
            os.path.join(self.results_folder, f"sample-{milestone}.pdb"),
            sampled_mol[:100],
            self.train_data.topology,
        )
