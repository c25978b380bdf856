"""Training driver: the port's ``Trainer`` at the configuration's published
training settings, one chunk of ``steps_per_chunk`` optimizer steps a timed
unit, as ``Trainer.train`` drives it: the chunk's batches drawn on the host
by the trainer's ``batch_iterator``, then ``Trainer._train_chunk``, which
draws each step's rotations, timesteps and noise from the generator it is
given.

Inputs from the seed: the synthetic training frames, the starting weights
(drawn on the device), the iterator's seed and the seed of the trainer's
generator. Set-up drives the one trainer through its first
``followed_steps`` steps (one-step chunks, on rows that all differ), keeps
what the check reads, and warms up past the EMA's copy phase; the window
then drives the same trainer. The check follows with the reference, its
draws made again from the generator's seed: the first steps from the
benchmark's own weights (each step's loss, the first gradient as the
optimizer got it, each leaf's change of weights and of the EMA), and one
window chunk drawn from the seed among the first ``COMPARED_WITHIN`` from
the program's state before it (weights, EMA, Adam's moments and count; each
leaf's change of weights and of the EMA over the chunk, across EMA updates
on the decay ramp).
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from benchmark.harness import synthetic, yardstick
from benchmark.harness.compare import widest
from benchmark.reference.network import flat_leaves

COMPARED_WITHIN = 4  # the compared window chunk is one of the window's first


class Driver:
    def __init__(self, cell):
        from twoforone_torch.core.diffusion import GaussianDiffusion
        from twoforone_torch.models import get_model
        from twoforone_torch.train.trainer import Trainer, batch_iterator
        from twoforone_torch.utils.config import TrainConfig
        from twoforone_torch.utils.convert import params_from_jax, params_to_jax

        from benchmark.reference.network import init_tree

        c, tr = cell.config, cell.traffic
        self.cell, dev = cell, cell.device
        n = c["n_beads"]
        self.published = c["train"]
        if self.published["loss_weights"] != "ones":
            raise ValueError("the reference draws timesteps under the loss weights 'ones' only")
        frames = synthetic.chain_dataset(tr["frames"], synthetic.CHAIN10_TORSION_COMPONENTS,
                                         seed=cell.seed_for("frames"))
        if frames.shape[1] != n:
            raise ValueError(f"the synthetic chains have {frames.shape[1]} beads, not {n}")
        self.norm_factor = float(frames.std())  # the training CLI's scale_data
        cell.mark("frames")
        self.folder = tempfile.mkdtemp(prefix="benchmark_train_")
        cfg = TrainConfig.from_dict(dict(self.published, mol=c["mol"], results_folder=self.folder,
                                         tensorboard_folder=self.folder, experiment_name="bench",
                                         batch_size=tr["batch_size"],
                                         hidden_features_gnn=c["hidden_nf"],
                                         num_layers_gnn=c["n_layers"], **c["edges"],
                                         conservative=True, diffusion_steps=c["timesteps"]))
        self.batch, self.chunk = cfg.batch_size, tr["steps_per_chunk"]
        gd = GaussianDiffusion(model=get_model(cfg, n), num_atoms=n, timesteps=c["timesteps"],
                               norm_factor=self.norm_factor, loss_weights=cfg.loss_weights)
        self.trainer = Trainer(gd, (None, None, None), c["mol"], cfg, use_tensorboard=False,
                               evaluators=False, device=dev)
        spec = {"n_beads": n, "hidden_nf": c["hidden_nf"], "n_layers": c["n_layers"]}
        weights_gen = torch.Generator(device=dev).manual_seed(cell.seed_for("weights"))
        self.init = {k: v.detach() for k, v in flat_leaves(init_tree(spec, weights_gen, dev)).items()}
        state = params_from_jax(_tree(self.init))
        self.trainer.net.load_state_dict(state)
        self.trainer.ema.load_state_dict(state)
        self.params_to_jax = params_to_jax
        self.names = [(k, p.shape) for k, p in self.trainer.net.named_parameters()]
        cell.mark("program")
        self.batches = batch_iterator(frames, self.batch, seed=cell.seed_for("iterator") % 2**31)
        self.draws_seed = cell.seed_for("draws")
        self.gen = torch.Generator(device=dev).manual_seed(self.draws_seed)
        self.work = {"train_steps": self.chunk}
        self.flops_per_unit = self.chunk * yardstick.train_step_flops(
            n, c["hidden_nf"], c["n_layers"], self.batch)
        self.failed = 0

        # The followed steps, one chunk of one step each; then the warm-up.
        self.followed, self.losses = [], []
        for i in range(tr["followed_steps"]):
            batches = self._batches(1)
            self.followed.append(batches[0])
            self.losses.append(float(self.trainer._train_chunk(batches, self.gen)["loss"]))
            if i == 0:
                self.first_mu = _flat(self.trainer._opt_state()["0"]["mu"])
        self.after_followed = self._state()
        cell.mark("followed steps")
        self.pick, self.done = -1, 0  # the compared chunk, and the chunks since set-up
        while self.trainer.step < tr["warmup_steps"]:
            self.unit()
        self.failed = 0
        self.pick = int(cell.rng("compare").integers(COMPARED_WITHIN))

    def _batches(self, k: int) -> np.ndarray:
        return np.stack([next(self.batches) for _ in range(k)])

    def _state(self):
        """The trainer's update count and its weights, EMA and Adam moments,
        each copied on the device into one flat tensor."""
        t = self.trainer
        params = list(t.net.parameters())

        def flat(tensors):
            return torch.cat([x.detach().reshape(-1) for x in tensors])

        mu, nu = ([t.optimizer.state[p].get(k, torch.zeros_like(p)) for p in params]
                  for k in ("mu", "nu"))
        return t.step, flat(params), flat(t.ema.parameters()), flat(mu), flat(nu)

    def unit(self):
        batches = self._batches(self.chunk)
        follow = self.done <= self.pick  # the pick-th chunk, or the window's last before it
        before = self._state() if follow else None
        loss = self.trainer._train_chunk(batches, self.gen)["loss"]
        if follow:
            self.compared = (before, batches, self._state())
        self.done += self.pick >= 0
        self.failed += not bool(torch.isfinite(loss))

    def failed_units(self) -> int:
        return self.failed

    def release(self):
        self.trainer = None
        shutil.rmtree(self.folder, ignore_errors=True)

    def _trees(self, state) -> dict:
        """``{"count", "weights", "ema", "mu", "nu"}`` of a :meth:`_state`,
        each tree as ``{path: tensor}`` on the device."""
        dev = self.cell.device
        out = {"count": state[0]}
        for name, flat in zip(("weights", "ema", "mu", "nu"), state[1:]):
            parts = flat.split([shape.numel() for _, shape in self.names])
            named = {k: v.view(shape) for (k, shape), v in zip(self.names, parts)}
            out[name] = {k: torch.tensor(v, device=dev)
                         for k, v in flat_leaves(self.params_to_jax(named)).items()}
        return out

    def reference(self, keep: slice = slice(None)) -> dict:
        """The reference's readings, under the caller's TF32 setting
        (``keep``: the rows each loss is taken over): ``followed``, from the
        benchmark's weights over the first steps, and ``window``, from the
        program's state before the compared chunk over that chunk."""
        from benchmark.reference.training import follow, steps

        c, dev = self.cell.config, self.cell.device

        def run(start, batches):
            gen = torch.Generator(device=dev).manual_seed(self.draws_seed)
            return follow(start, steps(batches, gen, start["count"], c["timesteps"]),
                          self.published, self.norm_factor, c["timesteps"], keep)

        before, batches, _ = self.compared
        return {"followed": run({"weights": self.init, "ema": self.init, "count": 0},
                                self.followed),
                "window": run(self._trees(before), batches)}

    def answer(self) -> dict:
        """The program's readings, as :meth:`reference` gives the reference's."""
        from benchmark.reference.training import B1

        dev = self.cell.device
        after = self._trees(self.after_followed)
        first = {k: torch.tensor(v, device=dev) / (1.0 - B1) for k, v in self.first_mu.items()}
        return {"followed": {"losses": self.losses, "first": first, **after},
                "window": self._trees(self.compared[2])}

    def readings(self, got: dict, ref: dict) -> dict:
        """The compared numbers of the program's readings ``got`` against
        the reference's ``ref`` (both as :meth:`reference` gives them)."""
        start = {"weights": self.init, "ema": self.init}
        window = self._trees(self.compared[0])
        f, rf = got["followed"], ref["followed"]
        changes = changed(start, f, rf, rf["first"])
        window_changes = changed(window, got["window"], ref["window"], ref["window"]["first"])
        return {"loss_gap": widest(abs(a - b) / abs(b) for a, b in zip(f["losses"], rf["losses"])),
                "grad_gap": worst_leaf(f["first"], rf["first"]),
                "change_gap": changes["weights"], "ema_gap": changes["ema"],
                "window_change_gap": window_changes["weights"],
                "window_ema_gap": window_changes["ema"]}

    def check(self) -> list:
        values = self.readings(self.answer(), self.reference())
        return [{"name": k, "value": float(v), "limit": self.cell.limits[k]}
                for k, v in values.items()]


def changed(start: dict, got: dict, ref: dict, grad: dict) -> dict:
    """The worst leaf's gap of the change from ``start`` of the weights and
    of the EMA. Entries whose reference gradient ``grad`` is nought to
    rounding (the keys' biases, under the softmax) move under Adam by
    round-off alone: the changes leave out every entry under a thousandth of
    the median leaf's RMS gradient."""
    rms = [float(v.norm()) / v.numel() ** 0.5 for v in grad.values()]
    floor = 1e-3 * float(np.median(rms))
    kept = {k: v.abs() >= floor for k, v in grad.items()}

    def change(tree, name):
        return {k: (tree[name][k] - start[name][k])[m] for k, m in kept.items() if m.any()}

    return {name: worst_leaf(change(got, name), change(ref, name)) for name in ("weights", "ema")}


def worst_leaf(got: dict, ref: dict) -> float:
    """The widest gap of a leaf's norm from the reference's, over the larger
    of that leaf's reference norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    return widest(abs(float(v.norm()) - norms[k]) / max(norms[k], median)
                  for k, v in got.items())


def _flat(tree) -> dict:
    return {k: np.array(v) for k, v in flat_leaves(tree).items()}


def _tree(leaves: dict) -> dict:
    """The nested tree of numpy arrays of ``{path: tensor}``."""
    tree = {}
    for path, v in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v.cpu().numpy()
    return tree
