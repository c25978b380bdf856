"""Langevin driver: chains of one configuration under BAOA(F)B through
``LangevinDiffusion(..., fused=<traffic>).sim.simulate``, one call of
``steps_per_call`` steps a timed unit, each saving one frame per
``save_interval`` steps to the host.

Inputs from the seed: the starting conformations (standard normal, centred,
times the norm factor) and the seed of the simulation's noise generator.
The check follows two calls with the reference, the noise drawn again
from the seed: the first call (in set-up) from the benchmark's own start,
and one drawn from the seed among the window's from the program's state
before it (its coordinates and velocities), each to the frame the call
returned. Over 500 chaotic steps the widest gap of 1000 chains swings with
the one chain that the dynamics amplifies most, so two numbers are
compared: the upper quartile over the chains of each chain's widest gap
(``x_gap_q3``), and how many chains' gaps pass the limit that quartile is
held to (``chains_off``), which a fault confined to a few chains fails.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import yardstick
from benchmark.harness.compare import chain_gaps, count_over, upper_quartile, widest


class Driver:
    def __init__(self, cell):
        from twoforone_torch.core.diffusion import GaussianDiffusion
        from twoforone_torch.dynamics.langevin import LangevinDiffusion
        from twoforone_torch.models.graph_transformer import GraphTransformer

        c, tr = cell.config, cell.traffic
        self.cell = cell
        n, chains = c["n_beads"], tr["chains"]
        self.batch = chains
        self.params = cell.staged_weights()
        cell.mark("weights")
        model = GraphTransformer(n, c["hidden_nf"], c["n_layers"], **c["edges"])
        gd = GaussianDiffusion(model=model, num_atoms=n, timesteps=c["timesteps"],
                               norm_factor=c["norm_factor"])
        init = cell.rng("start").standard_normal((chains, n, 3)).astype(np.float32)
        init = (init - init.mean(axis=1, keepdims=True)) * np.float32(c["norm_factor"])
        self.start = init / np.float32(c["norm_factor"])  # the first call's start, normalised
        self.noise_seed = cell.seed_for("noise")
        self.steps = tr["steps_per_call"]
        self.ld = LangevinDiffusion(
            gd, self.params, init, n_timesteps=self.steps * 10**6,
            save_interval=tr["save_interval"], t=c["langevin_t"], temp_data=c["temperature"],
            temp_sim=c["temperature"], dt=tr["dt"], masses=[tr["mass"]] * n,
            friction=tr["friction"], kb="consistent", random_seed=self.noise_seed, log=False,
            fused=tr["fused"], restraint_k=tr["restraint_k"], max_force=tr["max_force"],
            device=cell.device)
        cell.mark("program")
        self.calls = []  # (state before, frames) of every call
        self.work = {"chain_steps": chains * self.steps, "steps": self.steps}
        self.flops_per_unit = self.steps * yardstick.fused_force_flops(
            n, c["hidden_nf"], c["n_layers"], chains)
        self.unit()  # the warm-up call, which captures the step
        self.warmup = len(self.calls)

    def unit(self):
        state = self.ld.sim.state
        frames = self.ld.sim.simulate(sub_interval=self.steps)
        self.calls.append((state, frames))

    def failed_units(self) -> int:
        window = self.calls[self.warmup:self.warmup + self.window_units]
        return sum(not np.isfinite(f).all() for _, f in window)

    def release(self):
        self.ld = None

    def compared(self) -> list:
        """The first call, and one of the window's drawn from the seed."""
        pick = int(self.cell.rng("compare").integers(self.window_units))
        return [0, self.warmup + pick]

    def reference(self, k: int) -> torch.Tensor:
        """The reference's coordinates at the end of call ``k``, under the
        caller's TF32 setting: from the benchmark's own start for the first
        call, else from the program's state before the call."""
        from benchmark.reference import langevin as ref
        from benchmark.reference.network import tensors

        c, tr, dev = self.cell.config, self.cell.traffic, self.cell.device
        state = self.calls[k][0]
        if k == 0:
            state = {"x": self.start, "v": np.zeros_like(self.start), "t": 0}
        x = torch.tensor(state["x"], device=dev)
        v = torch.tensor(state["v"], device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.noise_seed)
        ref.skip_draws(gen, tuple(x.shape), int(state["t"]))
        xr, _ = ref.run(tensors(self.params, dev), x, v, self.steps, gen,
                        ref.constants(c, tr["dt"], tr["mass"], tr["friction"]),
                        tr["max_force"], tr["restraint_k"])
        return xr

    def answer(self, k: int) -> torch.Tensor:
        """The program's coordinates at the end of call ``k`` (its last frame)."""
        return torch.tensor(self.calls[k][1][:, -1], device=self.cell.device)

    def numbers(self, got: torch.Tensor, ref: torch.Tensor) -> dict:
        """The compared numbers of one call's coordinates ``got`` against
        the reference's ``ref``."""
        gaps = chain_gaps(got, ref)
        return {"x_gap_q3": upper_quartile(gaps),
                "chains_off": count_over(gaps, self.cell.limits["x_gap_q3"])}

    def check(self) -> list:
        values = [self.numbers(self.answer(k), self.reference(k)) for k in self.compared()]
        return [{"name": name, "value": widest(v[name] for v in values), "limit": limit}
                for name, limit in self.cell.limits.items()]
