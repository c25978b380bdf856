"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for and CUDA is absent, rather than
    falling back to the CPU: a run that meant to use the GPU must not quietly
    measure the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path on the host"
        )
    return dev
