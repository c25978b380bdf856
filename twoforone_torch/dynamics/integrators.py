"""Langevin / Brownian integrators (port of ``dynamics/integrators.py``).

- The BAOA(F)B step (one force evaluation per step) and the
  overdamped/Brownian step are plain tensor functions that take the noise as
  an argument.
- :class:`LangevinSimulation` drives them over chunks of
  ``steps_per_chunk`` steps (the JAX package's ``lax.scan``/``fori_loop``
  chunk). Saved frames stay on the device and are copied to the host once
  per chunk. The deterministic part of a step (centring, force, clamp,
  restraint, update in place) is one function, which the CPU calls from
  Python and the card captures once in a CUDA graph of one step and replays
  (:mod:`twoforone_torch.utils.cuda_graph`): the counterpart of the JAX
  package's compiled save period.
- Noise comes from a ``torch.Generator`` on the simulation's device, one
  draw of the coordinates' shape per step, so a trajectory does not depend
  on the chunking. The draws stay outside the graph: each step reads its
  noise, and its inverse temperature, from static buffers filled just
  before it, so a graphed run draws the numbers an eager one draws.
  The generator state is part of :attr:`state`, so a run
  resumed with :meth:`load_state` continues the uninterrupted trajectory.
- Spans (:mod:`twoforone_torch.utils.profiling`): ``langevin.step`` around
  each step's host work, ``langevin.frames`` around each chunk's copy of the
  saved frames to the host, ``langevin.state`` around :attr:`state`'s.
- Parallel chains are the leading batch axis. With a ``mesh``
  (:mod:`twoforone_torch.parallel.mesh`) rank r of W holds the chains
  ``[r n/W, (r+1) n/W)``; each step every rank draws the noise of all
  ``n`` chains from the run's generator and keeps its rows, so a sharded run
  equals the unsharded one chain for chain. The saved frames and the
  :attr:`state` are gathered, and only rank 0 writes exports and logs.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from twoforone_torch.ops.geometry import center_zero
from twoforone_torch.parallel.mesh import entry_device, gather, local_rows
from twoforone_torch.utils.cuda_graph import graphs_for, output, run, static
from twoforone_torch.utils.profiling import annotate

ForceFn = Callable[[torch.Tensor], tuple]  # x -> (potential, forces)


def baoab_step(x, v, forces, noise, dt, masses, vscale, noisescale, beta):
    """One BAOA(F)B update.

    [BB] v += dt * F / m
    [A]  x += v * dt/2
    [O]  v  = v * vscale + noisescale * sqrt(1/(beta m)) * dW
    [A]  x += v * dt/2
    """
    m = masses[:, None]
    v = v + dt * forces / m
    x = x + v * (dt / 2.0)
    v = v * vscale + noisescale * torch.sqrt(1.0 / (beta * m)) * noise
    x = x + v * (dt / 2.0)
    return x, v


def overdamped_step(x, forces, noise, dtau, beta):
    """Brownian dynamics step: x += F * dtau + sqrt(2 dtau / beta) * dW."""
    return _overdamped_update(x, forces, noise, dtau, float(_noise_coefficient(dtau, beta)))


def _noise_coefficient(dtau, beta):
    """sqrt(2 dtau / beta) on the host in float64 (``beta`` a float or a
    float32 array); the float32 product rounds it once, as a Python float
    operand or a float32 device scalar alike."""
    return np.sqrt(2.0 * dtau / np.asarray(beta, np.float64))


def _overdamped_update(x, forces, noise, dtau, noise_coef):
    return x + forces * dtau + noise_coef * noise


@dataclass
class LangevinSimulation:
    """Batched CG Langevin simulation driven by a force field.

    ``friction=None`` selects overdamped dynamics; otherwise BAOA(F)B with
    ``masses``. ``force_fn(x) -> (potential, forces)`` over a batch of chains
    (n_sims, n_beads, 3) on ``device``.

    ``restraint_k`` adds a harmonic tether ``F -= k x``; ``max_force`` clips
    each force component. ``steps_per_chunk`` sets how many steps run
    between host copies of the saved frames (default: at most 2^16 saved
    chain-frames on the device).

    ``mesh`` shards the chains over its ranks (``n_sims`` must be a
    multiple of its size); every rank then runs ``simulate`` together, and
    each gets the whole trajectory.
    """

    force_fn: ForceFn
    initial_coordinates: np.ndarray  # (n_sims, n_beads, 3)
    dt: float = 5e-4
    beta: float = 1.0
    friction: Optional[float] = None
    masses: Optional[Sequence[float]] = None
    diffusion: float = 1.0
    save_forces: bool = False
    save_potential: bool = False
    length: int = 100
    save_interval: int = 10
    random_seed: Optional[int] = None
    export_interval: Optional[int] = None
    log_interval: Optional[int] = None
    log_type: str = "write"
    filename: Optional[str] = None
    steps_per_chunk: Optional[int] = None
    restraint_k: float = 0.0
    max_force: Optional[float] = None
    device: object = "cuda"
    mesh: Optional[object] = None

    def __post_init__(self):
        self.device = entry_device(self.device, self.mesh)
        ic = np.asarray(self.initial_coordinates, dtype=np.float32)
        if ic.ndim != 3:
            raise ValueError("initial_coordinates shape must be [frames, beads, dimensions]")
        self.n_sims, self.n_beads, self.n_dims = ic.shape
        self._initial_x = ic
        self._rows = local_rows(self.n_sims, self.mesh)
        self._writer = self.mesh is None or self.mesh.rank == 0

        if self.length % self.save_interval != 0:
            raise ValueError("The save_interval must be a factor of the simulation length")
        if self.log_type not in ("print", "write"):
            raise ValueError("log_type can be either 'print' or 'write'")

        if self.friction is not None:
            if self.masses is None:
                raise RuntimeError("if friction is not None, masses must be given")
            if len(self.masses) != self.n_beads:
                raise ValueError("mass list length must be number of CG beads")
            self._masses = torch.tensor(self.masses, dtype=torch.float32, device=self.device)
            self.vscale = float(np.exp(-self.dt * self.friction))
            self.noisescale = float(np.sqrt(1.0 - self.vscale * self.vscale))
            if self.diffusion != 1:
                warnings.warn(
                    "Diffusion other than 1. was provided, but since friction and "
                    "masses were given, Langevin dynamics will be used which do "
                    "not incorporate this diffusion parameter"
                )
        else:
            self._dtau = self.diffusion * self.dt
            self._masses = None
            if self.masses is not None:
                warnings.warn(
                    "Masses were provided, but will not be used since friction "
                    "is None (i.e., infinite)."
                )

        # Only the writer (rank 0) looks for files it would overwrite.
        if self.export_interval is not None:
            if self.filename is None:
                raise RuntimeError("Must specify filename if export_interval isn't None")
            if self.length // self.export_interval >= 1000:
                raise ValueError(
                    "Simulation saving is not implemented if more than 1000 files "
                    "will be generated"
                )
            if self._writer and os.path.isfile(f"{self.filename}_coords_000.npy"):
                raise ValueError(
                    f"{self.filename}_coords_000.npy already exists; choose a "
                    "different filename."
                )
            if self.export_interval % self.save_interval != 0:
                raise ValueError("Numpy saving must occur at a multiple of save_interval")
        if self.log_interval is not None:
            if self.log_interval % self.save_interval != 0:
                raise ValueError("Logging must occur at a multiple of save_interval")
            if self.log_type == "write":
                if self.filename is None:
                    raise RuntimeError(
                        "Must specify filename if log_interval isn't None and "
                        "log_type=='write'"
                    )
                self._log_file = self.filename + "_log.txt"
                if self._writer and os.path.isfile(self._log_file):
                    raise ValueError(
                        f"{self._log_file} already exists; choose a different filename."
                    )

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0 if self.random_seed is None else self.random_seed)
        # The step's CUDA graphs on the card; None runs the eager loop (the
        # CPU's, and the card's only where a comparison sets it so).
        self._graphs = graphs_for(self.device)
        self._state = None  # (x, v) device tensors; populated lazily
        self._t = 0  # global step counter (resumable)
        self._npy_file_index = 0

    # ------------------------------------------------------------------ state
    def _init_state(self):
        x = torch.from_numpy(self._initial_x[self._rows]).to(self.device)
        v = torch.zeros_like(x) if self.friction is not None else None
        return x, v

    @property
    def state(self) -> dict:
        """Checkpointable integrator state (x, v, t, generator state), of
        all chains (under a mesh every rank reads it together)."""
        if self._state is None:
            self._state = self._init_state()
        x, v = self._state
        with annotate("langevin.state"):
            return {
                "x": gather(x, self.mesh).cpu().numpy(),
                "v": None if v is None else gather(v, self.mesh).cpu().numpy(),
                "t": self._t,
                "key": self._gen.get_state().numpy(),
            }

    def load_state(self, state: dict):
        rows = self._rows
        x = torch.as_tensor(np.asarray(state["x"], np.float32)[rows], device=self.device)
        v = state["v"]
        v = None if v is None else torch.as_tensor(np.asarray(v, np.float32)[rows],
                                                   device=self.device)
        self._state = (x, v)
        self._t = int(state["t"])
        self._gen.set_state(torch.as_tensor(np.asarray(state["key"], np.uint8)))

    # ------------------------------------------------------------- hot loop
    def _draw_noise(self, like: torch.Tensor) -> torch.Tensor:
        """The step's noise for this rank's chains: all chains' draw, then
        its rows."""
        noise = torch.randn((self.n_sims, *like.shape[1:]), generator=self._gen,
                            device=self.device, dtype=like.dtype)
        return noise if self.mesh is None else noise[self._rows]

    def one_step(self, x, v, beta, noise):
        """Centre, evaluate forces, and advance one step with the given
        standard-normal ``noise``. Returns (x, v, potential, forces)."""
        return self._advance(x, v, self._step_coefficients(beta), noise)

    def _step_coefficients(self, beta):
        """What a step reads of the inverse temperature ``beta`` (a float, or
        the float32 array of a run's steps): beta itself for BAOA(F)B, the
        noise coefficient sqrt(2 dtau / beta) in overdamped dynamics."""
        if self.friction is not None:
            return beta
        coef = _noise_coefficient(self._dtau, beta)
        return float(coef) if np.ndim(coef) == 0 else coef.astype(np.float32)

    def _advance(self, x, v, coef, noise):
        """:meth:`one_step` with ``coef`` from :meth:`_step_coefficients`, a
        float (``one_step``'s) or a 0-d float32 tensor (``simulate``'s), which
        give the same float32 products."""
        x = center_zero(x)
        potential, forces = self.force_fn(x)
        if self.max_force is not None:
            forces = torch.clamp(forces, -self.max_force, self.max_force)
        if self.restraint_k:
            forces = forces - self.restraint_k * x
        if self.friction is not None:
            x_new, v_new = baoab_step(
                x, v, forces, noise, self.dt, self._masses, self.vscale,
                self.noisescale, coef,
            )
        else:
            x_new = _overdamped_update(x, forces, noise, self._dtau, coef)
            v_new = v
        return x_new, v_new, potential, forces

    def _step(self, x, v, coef, noise):
        """The device work of one step (what a graph records): :meth:`_advance`
        with ``x`` and ``v`` advanced in place; returns (potential, forces)."""
        x_new, v_new, potential, forces = self._advance(x, v, coef, noise)
        x.copy_(x_new)
        if v is not None:
            v.copy_(v_new)
        return potential, forces

    # ------------------------------------------------------------- driving
    @torch.no_grad()
    def simulate(self, sub_interval: Optional[int] = None,
                 reference_beta: Optional[float] = None) -> np.ndarray:
        """Advance the simulation by ``sub_interval`` steps (default: all).

        Returns saved coordinates with shape (n_sims, n_frames_saved,
        n_beads, 3).

        ``reference_beta`` enables the tempering ramp: kbT ramps linearly
        from 1/reference_beta up to 1/beta over a quarter of the interval,
        holds, ramps back down, then holds at 1/reference_beta.
        """
        sub_interval = self.length if sub_interval is None else sub_interval
        if sub_interval % self.save_interval != 0:
            raise ValueError("sub_interval must be a multiple of save_interval")
        if self._state is None:
            self._state = self._init_state()
            self._log(
                f"Generating {self.n_sims} simulations of length {self.length} "
                f"saved at {self.save_interval}-step intervals ({time.asctime()})"
            )

        if reference_beta is not None:
            q = sub_interval // 4
            kbt = np.concatenate([
                np.linspace(1 / reference_beta, 1 / self.beta, num=q),
                np.full(q, 1 / self.beta),
                np.linspace(1 / self.beta, 1 / reference_beta, num=q),
                np.full(sub_interval - 3 * q, 1 / reference_beta),
            ])
            betas_all = (1.0 / kbt).astype(np.float32)
        else:
            betas_all = np.full(sub_interval, self.beta, dtype=np.float32)

        steps_per_chunk = self.steps_per_chunk
        if steps_per_chunk is None:
            saves = max(1, min(sub_interval // self.save_interval,
                               65536 // max(1, self.n_sims)))
            steps_per_chunk = saves * self.save_interval
        steps_per_chunk -= steps_per_chunk % self.save_interval
        steps_per_chunk = max(self.save_interval, steps_per_chunk)

        remaining = min(sub_interval, self.length - self._t)
        total_saves = remaining // self.save_interval
        shape = (total_saves, self.n_sims, self.n_beads, self.n_dims)
        coords_out = np.empty(shape, dtype=np.float32)
        forces_out = np.empty(shape, dtype=np.float32) if self.save_forces else None
        potential_out = None
        ke_out = (np.empty((total_saves, self.n_sims), dtype=np.float32)
                  if self.friction is not None else None)

        # The loop's own state, advanced in place (on the card the graph's
        # static buffers): what leaves the loop is a copy, so no caller holds
        # a tensor that a later step overwrites.
        graphs = self._graphs
        x, v = self._state
        x = output(graphs, "x", x).copy_(x)
        v = None if v is None else output(graphs, "v", v).copy_(v)
        coefs_all = torch.as_tensor(self._step_coefficients(betas_all), device=self.device)
        done = save_idx = export_start = 0
        while done < remaining:
            chunk = min(steps_per_chunk, remaining - done)
            saved = {"coords": [], "forces": [], "potential": [], "kinetic_energy": []}
            for i in range(chunk):
                with annotate("langevin.step"):
                    noise = static(graphs, "noise", self._draw_noise(x))
                    coef = static(graphs, "coef", coefs_all[done + i])
                    potential, forces = run(graphs, ("step", tuple(x.shape)),
                                            partial(self._step, x, v, coef, noise))
                    if (i + 1) % self.save_interval == 0:
                        saved["coords"].append(x.clone())
                        if self.save_forces:
                            saved["forces"].append(forces.clone())
                        if self.save_potential:
                            saved["potential"].append(potential.clone())
                        if ke_out is not None:
                            saved["kinetic_energy"].append(
                                0.5 * torch.sum(self._masses[:, None] * v**2, dim=(1, 2))
                            )
            n_saves = chunk // self.save_interval
            sl = slice(save_idx, save_idx + n_saves)

            def host(name):  # (n_saves, all chains, ...) on the host
                return gather(torch.stack(saved[name]), self.mesh, dim=1).cpu().numpy()

            with annotate("langevin.frames"):
                coords_out[sl] = host("coords")
                if self.save_forces:
                    forces_out[sl] = host("forces")
                if self.save_potential:
                    pot = host("potential")
                    if potential_out is None:
                        potential_out = np.empty((total_saves,) + pot.shape[1:], dtype=np.float32)
                    potential_out[sl] = pot
                if ke_out is not None:
                    ke_out[sl] = host("kinetic_energy")
            done += chunk
            save_idx += n_saves
            self._t += chunk

            if self.export_interval is not None and self._writer:
                while (save_idx - export_start) * self.save_interval >= self.export_interval:
                    n_exp = self.export_interval // self.save_interval
                    self._export_npy(coords_out, forces_out, potential_out, ke_out,
                                     export_start, export_start + n_exp)
                    export_start += n_exp
            if self.log_interval is not None and (self._t % self.log_interval) < self.save_interval:
                self._log(
                    f"{save_idx}/{self.length // self.save_interval} time points "
                    f"saved ({time.asctime()})"
                )

        if self.export_interval is not None and self._writer and export_start < save_idx:
            self._export_npy(coords_out, forces_out, potential_out, ke_out,
                             export_start, save_idx)

        self._state = (x.clone(), None if v is None else v.clone())
        # (saves, sims, beads, 3) -> (sims, saves, beads, 3)
        self.simulated_coords = coords_out.swapaxes(0, 1)
        self.simulated_forces = None if forces_out is None else forces_out.swapaxes(0, 1)
        self.simulated_potential = (
            None if potential_out is None else potential_out.swapaxes(0, 1)
        )
        self.kinetic_energies = None if ke_out is None else ke_out.swapaxes(0, 1)
        return self.simulated_coords

    # ------------------------------------------------------------- plumbing
    def _export_npy(self, coords, forces, potential, ke, start, stop):
        key = f"{self._npy_file_index:03d}"
        np.save(f"{self.filename}_coords_{key}.npy", coords[start:stop].swapaxes(0, 1))
        if forces is not None:
            np.save(f"{self.filename}_forces_{key}.npy", forces[start:stop].swapaxes(0, 1))
        if potential is not None:
            np.save(f"{self.filename}_potential_{key}.npy", potential[start:stop].swapaxes(0, 1))
        if ke is not None:
            np.save(f"{self.filename}_kineticenergy_{key}.npy", ke[start:stop].swapaxes(0, 1))
        self._npy_file_index += 1

    def _log(self, msg: str):
        if self.log_interval is None or not self._writer:
            return
        if self.log_type == "print":
            print(msg)
        else:
            with open(self._log_file, "a") as f:
                f.write(msg + "\n")
