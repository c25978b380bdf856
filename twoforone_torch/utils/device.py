"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import functools

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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card: the grid of a kernel that keeps a
    fixed number of thread blocks resident follows it."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@contextlib.contextmanager
def float32_products():
    """cuBLAS and cuDNN products summed in float32 while the block runs: no
    TF32 for float32 operands, and no reduced-precision reduction for
    bfloat16 ones (XLA sums bfloat16 products in float32); the caller's
    settings come back afterwards. A CUDA graph keeps the kernels chosen at
    its capture, so this also fixes what every replay runs."""
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = before
