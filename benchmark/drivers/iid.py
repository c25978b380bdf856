"""i.i.d. sampling driver: one call of the sampling closure
``GaussianDiffusion.make_fused_sample_fn(params, batch, kernel=<traffic>,
sample_steps=<traffic>, solver=<traffic>)`` a timed unit, each a whole batch
of samples returned to the caller.

Two solvers: deterministic DDIM (``"solver": "ddim"``, ``sample_steps``
score calls), and the full ancestral chain (``"solver": "ancestral"`` with
``"sample_steps": null``: T score calls, ``p_sample_loop``).

Inputs from the seed: one generator seed per batch, from which the closure
draws the batch's starting noise and then each step's noise (which
deterministic DDIM multiplies by zero). The check runs the reference sampler
from the same draws (made again from the batch's seed) for two batches: the
first (in set-up) and one drawn from the seed among the window's, and
compares the samples (:meth:`Driver.numbers`).
"""

from __future__ import annotations

import torch

from benchmark.harness import yardstick
from benchmark.harness.compare import count_over, gap, sample_gaps, upper_quartile, widest
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
        self.ancestral = tr["solver"] == "ancestral" and tr["sample_steps"] is None
        if not self.ancestral and tr["solver"] != "ddim":
            raise ValueError("the reference samples with deterministic DDIM or the full "
                             "ancestral chain (sample_steps null) only")
        calls = c["timesteps"] if self.ancestral else len(ladder(c["timesteps"],
                                                                 tr["sample_steps"]))
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

    def references(self, ks: list, dtype=None) -> list:
        """The reference's samples of the batches ``ks``, under the caller's
        TF32 setting, in ``dtype``: by default float32 for DDIM and float64
        for the ancestral chain, whose T steps amplify the float32
        reference's own rounding on a few samples as far as the program's.
        DDIM follows one batch at a time. The ancestral chain's T steps are
        most of the check's time, so it follows the batches' rows together
        in one chain (each row's chain is its own), each step's noise drawn
        from each batch's generator in turn."""
        from benchmark.reference.network import tensors
        from benchmark.reference.sampling import ancestral, ddim

        c, dev = self.cell.config, self.cell.device
        shape = (self.batch, c["n_beads"], 3)
        gens = [self._generator(k) for k in ks]
        x_init = [torch.randn(shape, generator=g, device=dev) for g in gens]
        if not self.ancestral:
            params = tensors(self.params, dev, dtype or torch.float32)
            return [ddim(params, x, c, self.cell.traffic["sample_steps"]) for x in x_init]
        dtype = dtype or torch.float64

        def draws():
            return torch.cat([torch.randn(shape, generator=g, device=dev) for g in gens]).to(dtype)

        return list(ancestral(tensors(self.params, dev, dtype), torch.cat(x_init).to(dtype),
                              draws, c).split(self.batch))

    def answer(self, k: int) -> torch.Tensor:
        return self.outputs[k]

    def numbers(self, got: torch.Tensor, ref: torch.Tensor) -> dict:
        """The compared numbers of one batch's samples ``got`` against the
        reference's ``ref``. DDIM: the widest gap over the batch. The
        ancestral chain: the upper quartile of the samples' gaps, and the
        samples whose gap passes that quartile's limit (a sample that blows
        up to the guard's clamp follows float32 rounding, so the widest gap
        would read it alone)."""
        if not self.ancestral:
            return {"sample_gap": gap(got, ref)}
        gaps = sample_gaps(got, ref)
        return {"sample_gap_q3": upper_quartile(gaps),
                "samples_off": count_over(gaps, self.cell.limits["sample_gap_q3"])}

    def check(self) -> list:
        ks = self.compared()
        values = [self.numbers(self.answer(k), ref) for k, ref in zip(ks, self.references(ks))]
        return [{"name": name, "value": widest(v[name] for v in values), "limit": limit}
                for name, limit in self.cell.limits.items()]
