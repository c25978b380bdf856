"""The bars of ``chip_smoke.py`` phase 13 (a): how far the JAX package's own
bfloat16 Langevin trajectory lies from its float32 one.

    python3 scripts/torch_bf16_bars.py

Runs the JAX package on the CPU (float32 products at "highest" precision, as
its tests run) on the staged villin (chain35) and protein-G (chain56)
weights: 10 BAOAB steps at bench.py's settings from ``chip_smoke.py``'s
start and noise (``start_state`` and ``normal(9, ...)``, 100 chains), once
with the float32 force and once with ``bf16=True``. Prints one JSON line per
model: the largest coordinate difference in units of the largest |x|, and
the bar ``C_RULE * that + FLOOR`` of ``tests/test_torch_bf16.py``'s rule
that phase 13 holds the port's bfloat16 trajectory to (against the port's
float32 one: the card has no JAX).
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from twoforone_tpu.core.diffusion import GaussianDiffusion  # noqa: E402
from twoforone_tpu.dynamics import integrators  # noqa: E402
from twoforone_tpu.dynamics.langevin import LangevinDiffusion, make_diffusion_force_fn  # noqa: E402
from twoforone_tpu.models.graph_transformer import GraphTransformer  # noqa: E402
from twoforone_tpu.ops.geometry import center_zero  # noqa: E402

C_RULE, FLOOR = 2.0, 2.0**-8  # tests/test_torch_bf16.py


def ten_steps(spec, chains=cs.BF16_CHAINS):
    n = spec["n"]
    model = GraphTransformer(num_beads=n, hidden_nf=spec["nf"], n_layers=3, conservative=True,
                             **cs.EDGES)
    gd = GaussianDiffusion(model=model, num_atoms=n, timesteps=1000, norm_factor=spec["norm"],
                           loss_weights="higheruntil_100")
    path = os.path.join(ROOT, "twoforone_tpu", "assets", "trained", spec["name"],
                        "model-best.msgpack")
    with open(path, "rb") as f:
        params = serialization.msgpack_restore(f.read())["ema_params"]
    init = cs.start_state(chains, n, spec["norm"])
    noise = np.random.default_rng(9).normal(size=(10, chains, n, 3)).astype(np.float32)
    kw = dict(t=spec["t_noise"], temp_data=spec["temp"], temp_sim=spec["temp"], dt=2e-3,
              masses=[12.0] * n, friction=1.0, kb="consistent", restraint_k=50.0,
              max_force=1e3)
    finals = {}
    for bf16 in (False, True):
        ld = LangevinDiffusion(gd, params, init, n_timesteps=10, save_interval=10, log=False,
                               **kw)
        sim = ld.sim
        force = jax.jit(make_diffusion_force_fn(gd, params, spec["t_noise"],
                                                ld.kb_inv / spec["temp"], bf16=bf16))
        x, v = jnp.asarray(init / ld.norm_factor), jnp.zeros((chains, n, 3))
        for k in range(10):
            x = center_zero(x)
            _, forces = force(x)
            forces = jnp.clip(forces, -1e3, 1e3) - 50.0 * x
            x, v = integrators.baoab_step(x, v, forces, jnp.asarray(noise[k]), sim.dt,
                                          sim._masses, sim.vscale, sim.noisescale, sim.beta)
        finals[bf16] = np.asarray(x, np.float64) * ld.norm_factor
    scale = np.abs(finals[False]).max()
    dist = np.abs(finals[True] - finals[False]).max() / scale
    return dict(name=spec["name"], chains=chains, max_abs_x=scale,
                jax_bf16_vs_f32_in_max_x=dist, bar=C_RULE * dist + FLOOR)


if __name__ == "__main__":
    for spec in (cs.VILLIN, cs.PROTEIN_G):
        print(json.dumps(ten_steps(spec)), flush=True)
