"""Batched sampling driver (port of ``num_to_groups`` and
``sample_from_model`` in ``twoforone_tpu/evaluate/evaluators.py``; the
evaluators themselves are not ported yet)."""

from __future__ import annotations

import time

import numpy as np
import torch


def num_to_groups(num: int, divisor: int):
    """[divisor] * (num // divisor) + optional remainder."""
    groups, remainder = divmod(num, divisor)
    arr = [divisor] * groups
    if remainder > 0:
        arr.append(remainder)
    return arr


def sample_from_model(sample_fn, num_saved_samples: int, batch_size: int,
                      generator: torch.Generator, verbose: bool = False) -> np.ndarray:
    """Draw ``num_saved_samples`` samples in batches and concatenate them on
    the host: (num_saved_samples, N, 3) numpy float32.

    ``sample_fn(batch_size, generator) -> (batch, N, 3)``; every batch draws
    from the one ``generator``, which lives on the run's device. The
    remainder batch samples a full batch and is truncated, so the sampler
    sees one batch shape: a CUDA graph (the clx force evaluation) is
    captured, and keeps its memory pool, once per shape.
    """
    print(f"Generating {num_saved_samples} samples. This may take some time.")
    batches = num_to_groups(num_saved_samples, batch_size)
    out = []
    last_print = time.monotonic()
    for i, b in enumerate(batches):
        full = sample_fn(batch_size, generator)
        out.append(full[:b].cpu().numpy())
        if verbose or time.monotonic() - last_print > 60.0:
            print(f"Batch {i + 1} from {len(batches)} generated", flush=True)
            last_print = time.monotonic()
    all_mol = np.concatenate(out, axis=0)
    print(f"{len(all_mol)} samples generated")
    return all_mol
