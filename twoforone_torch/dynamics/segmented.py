"""Segment-checkpointed Langevin driving (port of
``twoforone_tpu/dynamics/segmented.py``).

A control run's Langevin stage is its longest atomic unit. Driven in
segments, with the frames streamed to disk and the integrator state
checkpointed at every boundary, a crash or a preemption costs one segment,
not the stage.

The segmentation is invisible in the output: the noise of every step comes
from the simulation's ``torch.Generator``, one draw a step whatever the
chunking, and the generator's state (a CPU generator's Mersenne state, or a
CUDA generator's Philox seed and offset, as a uint8 array) is part of the
checkpoint. So any split of the run, and a run resumed from the checkpoint
in a fresh process, gives the frames of one ``LangevinDiffusion.sample()``
bit for bit.
"""

from __future__ import annotations

import os

import numpy as np

from twoforone_torch.utils.preempt import exit_if_preempted


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def segmented_sample(ld, folder: str, name: str,
                     segment_steps: int | None = None,
                     resume: bool = False) -> np.ndarray:
    """Drive ``ld`` (a LangevinDiffusion) to completion in checkpointed
    segments; returns exactly what ``ld.sample()`` returns ((n_frames,
    beads, 3), data units, chain-major).

    State lives in ``folder/{name}_state.npz``; each segment's frames in
    ``folder/{name}_seg####.npy`` (normalized units, as saved by the
    integrator). Call :func:`cleanup` after persisting the consolidated
    result. Tempering ramps are not supported (their kbT profile is a
    function of the full interval, so segmenting would change it).
    """
    sim = ld.sim
    si = sim.save_interval
    length = sim.length
    if segment_steps is None:
        # ~10 segments: minutes-scale preemption latency and redo cost at
        # every production control size, without littering tiny files.
        segment_steps = max(1, round(length / 10 / si)) * si
    if segment_steps % si != 0:
        raise ValueError("segment_steps must be a multiple of save_interval")

    state_path = os.path.join(folder, f"{name}_state.npz")
    if resume and os.path.exists(state_path):
        st = np.load(state_path)
        sim.load_state({
            "x": st["x"], "v": None if st["v"].ndim == 0 else st["v"],
            "t": int(st["t"]), "key": st["key"],
        })
        print(f"segmented stage '{name}': resumed at step {int(st['t'])}",
              flush=True)

    while sim._t < length:
        seg = sim._t // segment_steps
        exit_if_preempted(f"stage '{name}' segment {seg}")
        coords = sim.simulate(
            sub_interval=min(segment_steps, length - sim._t)
        )  # (n_sims, n_saves_this_segment, beads, 3), normalized
        # Frames before state: a crash between the two re-runs the segment,
        # which overwrites the same file with identical frames (the
        # generator state is checkpointed), never duplicates or skips any.
        _atomic_save(os.path.join(folder, f"{name}_seg{seg:04d}.npy"),
                     coords.astype(np.float32))
        st = sim.state
        _atomic_savez(state_path, x=st["x"],
                      v=np.zeros(()) if st["v"] is None else st["v"],
                      t=st["t"], key=st["key"])

    n_segments = -(-length // segment_steps)
    frames = np.concatenate([
        np.load(os.path.join(folder, f"{name}_seg{s:04d}.npy"))
        for s in range(n_segments)
    ], axis=1)
    # The LangevinDiffusion.sample contract: chain-major flatten, data units.
    frames = frames.reshape(-1, frames.shape[2], frames.shape[3])
    return frames * ld.norm_factor


def cleanup(folder: str, name: str) -> None:
    """Remove a completed stage's segment/state files (call after the
    consolidated result is persisted)."""
    for f in sorted(os.listdir(folder)):
        if f.startswith(f"{name}_seg") and f.endswith(".npy"):
            os.remove(os.path.join(folder, f))
    state = os.path.join(folder, f"{name}_state.npz")
    if os.path.exists(state):
        os.remove(state)
