"""i.i.d. sampling driver: one call of the sampling closure
``GaussianDiffusion.make_fused_sample_fn(params, batch, kernel=<traffic>,
sample_steps=<traffic>, solver=<traffic>)`` a timed unit, each a whole batch
of samples returned to the caller.

Inputs from the seed: one generator seed per batch, from which the closure
draws the batch's starting noise (and the steps' draws, which deterministic
DDIM multiplies by zero). The check runs the reference sampler from the same
starting noise (drawn again from the batch's seed) for ``compare_batches``
batches: the first (in set-up) and one drawn from the seed among the
window's, and compares the samples.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import yardstick
from benchmark.harness.compare import gap, widest
from benchmark.reference.sampling import ladder


class Driver:
    def __init__(self, cell):
        from twoforone_torch.core.diffusion import GaussianDiffusion
        from twoforone_torch.models.graph_transformer import GraphTransformer

        c, tr = cell.config, cell.traffic
        self.cell = cell
        n, self.batch = c["n_beads"], tr["batch"]
        self.params = cell.staged_weights()
        cell.mark("weights")
        model = GraphTransformer(n, c["hidden_nf"], c["n_layers"], **c["edges"])
        gd = GaussianDiffusion(model=model, num_atoms=n, timesteps=c["timesteps"],
                               norm_factor=c["norm_factor"])
        self.sample = gd.make_fused_sample_fn(self.params, self.batch, kernel=tr["kernel"],
                                              sample_steps=tr["sample_steps"], eta=0.0,
                                              solver=tr["solver"], device=cell.device)
        cell.mark("program")
        self.base_seed = cell.seed_for("batches")
        self.outputs = []
        if tr["solver"] != "ddim":
            raise ValueError("the reference samples with deterministic DDIM only")
        calls = len(ladder(c["timesteps"], tr["sample_steps"]))
        self.work = {"samples": self.batch, "score_calls": calls}
        self.flops_per_unit = calls * yardstick.fused_force_flops(
            n, c["hidden_nf"], c["n_layers"], self.batch)
        self.unit()  # the warm-up batch
        self.warmup = len(self.outputs)

    def _generator(self, k: int) -> torch.Generator:
        return torch.Generator(device=self.cell.device).manual_seed(self.base_seed + k)

    def unit(self):
        out = self.sample(generator=self._generator(len(self.outputs)))
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
        self.outputs.append(out)

    def failed_units(self) -> int:
        window = self.outputs[self.warmup:self.warmup + self.window_units]
        return sum(not bool(torch.isfinite(o).all()) for o in window)

    def release(self):
        self.sample = None

    def compared(self) -> list:
        pick = int(self.cell.rng("compare").integers(self.window_units))
        return [0, self.warmup + pick]

    def reference(self, k: int) -> torch.Tensor:
        """The reference's samples of batch ``k``, under the caller's TF32
        setting."""
        from benchmark.reference.network import tensors
        from benchmark.reference.sampling import ddim

        shape = (self.batch, self.cell.config["n_beads"], 3)
        x_init = torch.randn(shape, generator=self._generator(k), device=self.cell.device)
        return ddim(tensors(self.params, self.cell.device), x_init, self.cell.config,
                    self.cell.traffic["sample_steps"])

    def answer(self, k: int) -> torch.Tensor:
        return self.outputs[k]

    def numbers(self, got: torch.Tensor, ref: torch.Tensor) -> dict:
        """The compared number of one batch's samples ``got`` against the
        reference's ``ref``."""
        return {"sample_gap": gap(got, ref)}

    def check(self) -> list:
        worst = widest(self.numbers(self.answer(k), self.reference(k))["sample_gap"]
                       for k in self.compared())
        return [{"name": "sample_gap", "value": worst, "limit": self.cell.limits["sample_gap"]}]
