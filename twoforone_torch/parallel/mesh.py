"""The device mesh as a process group (port of ``twoforone_tpu/parallel/mesh.py``).

The JAX package runs one process per host, which drives every local chip,
and lays a 1-D ``jax.sharding.Mesh`` over all of them. PyTorch's idiom is
one process per GPU in a ``torch.distributed`` process group, and so is the
port's: the mesh's data axis is the group's ranks, and rank r drives
``cuda:{LOCAL_RANK}``. Under torchrun,

    python -m torch.distributed.run --nproc_per_node K -m twoforone_torch.cli.train ...

the same command spans K GPUs; a plain ``python -m ...`` is a world of one.

- training: each rank draws its share of the global batch; the weights
  start identical (broadcast from rank 0); the gradient is all-reduced as
  one flat buffer before the optimizer;
- i.i.d. sampling and Langevin chains: the chain axis is split over the
  ranks with no collective in the hot loop (chains are independent); what
  comes out is gathered.

Backends (:func:`default_backend`, unless the caller names one): ``nccl``
where the rank's device is a GPU, ``gloo`` on the CPU. NCCL refuses two
ranks on one device ("Duplicate GPU detected"), so the ranks of one host
that all name the same card (a check on a machine with one GPU) share it
over ``gloo``. Gloo's collectives take CUDA tensors for ``broadcast`` and
``all_reduce`` but not for ``all_gather``, so :func:`gather` copies through
the host under gloo.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from twoforone_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks, this process's ``rank`` and ``device``,
    the process ``group`` the collectives run in and its ``backend`` (None:
    a world of one with no process group)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index is
    ``cuda:{LOCAL_RANK}`` (torchrun sets it; 0 otherwise); anything else is
    taken as given. Raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def default_backend(device="cuda") -> str:
    """``nccl`` for a GPU, ``gloo`` for the CPU, and ``gloo`` for GPU ranks
    that share a card: ``device`` names an index and torchrun starts more
    than one rank on this host (``LOCAL_WORLD_SIZE``), so every one of them
    names that card, and NCCL refuses two ranks on one device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    shared = dev.index is not None and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1
    return "gloo" if shared else "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join this process to a process group; True once it is in one.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` configure the group explicitly; otherwise torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) does. With neither, and ``num_processes`` None or <= 1, this
    is a no-op that returns False, so a launch script may always pass
    ``--multihost``. A process already in a group stays in it.

    ``backend`` defaults to :func:`default_backend` of ``device``; the
    rank's device is :func:`rank_device` of it. ``timeout`` bounds the
    rendezvous and every collective.
    """
    if dist.is_initialized():
        return True
    from_env = os.environ.get("MASTER_ADDR") or os.environ.get("WORLD_SIZE")
    if coordinator_address is None and not from_env and (num_processes is None
                                                          or num_processes <= 1):
        return False
    if coordinator_address is None and not os.environ.get("MASTER_ADDR"):
        raise ValueError(
            f"num_processes={num_processes} but no coordinator: pass "
            "coordinator_address='host:port' or launch with torchrun")
    dev = rank_device(device)
    backend = backend or default_backend(device)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    return True


def get_mesh(device="cuda") -> Mesh:
    """The 1-D mesh over every process of the job (call
    :func:`initialize_distributed` first), with this rank on
    :func:`rank_device` of ``device``. Without a process group it is a
    world of one."""
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, dev)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl process group needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.get_world_size(), dist.get_rank(), dev, dist.group.WORLD, backend)


def entry_device(device, mesh: Optional[Mesh] = None) -> torch.device:
    """The device an entry point runs on: ``device`` (resolved), or the
    rank's device when a ``mesh`` is given. Raises when ``mesh`` is not a
    :class:`Mesh` or when ``device`` names another device than the mesh's."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a twoforone_torch.parallel.mesh.Mesh, not {type(mesh)}")
    if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
        raise ValueError(f"device={device!r} but the mesh places this rank on {mesh.device}")
    return mesh.device


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def round_to_mesh(n: int, mesh: Optional[Mesh]) -> int:
    """Smallest multiple of the mesh size >= n (chain/batch-axis padding)."""
    d = mesh_size(mesh)
    return ((n + d - 1) // d) * d


def local_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a chain or batch axis of length ``n``: rank r of
    W holds ``[r n/W, (r+1) n/W)``. ``n`` must be a multiple of W."""
    d = mesh_size(mesh)
    if n % d:
        raise ValueError(f"{n} chains or samples must be divisible by the mesh size {d} "
                         "(pad the count, e.g. parallel.mesh.round_to_mesh)")
    per = n // d
    rank = 0 if mesh is None else mesh.rank
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, mesh: Optional[Mesh] = None, device="cuda") -> torch.Tensor:
    """This rank's part of a global batch as a float32 tensor on the rank's
    device (on ``device`` without a mesh, the card by default: it raises
    where CUDA is absent unless ``device="cpu"``). As in the JAX package's
    multi-process form, each process passes its LOCAL part (the global batch
    axis is the local one times the mesh size); no data crosses ranks."""
    return torch.as_tensor(batch, dtype=torch.float32,
                           device=resolve_device(device) if mesh is None else mesh.device)


def _distributed(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.backend is not None


def replicate(module_or_tensors, mesh: Optional[Mesh] = None):
    """Make every rank hold rank 0's values: broadcast each parameter and
    buffer of a module, or each tensor of a list, in place; returns its
    argument."""
    if _distributed(mesh):
        tensors = (list(module_or_tensors.state_dict().values())
                   if isinstance(module_or_tensors, torch.nn.Module) else module_or_tensors)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=0, group=mesh.group)
    return module_or_tensors


def all_reduce_(tensor: torch.Tensor, mesh: Optional[Mesh] = None, op: str = "mean"):
    """In place over the ranks: ``"mean"`` (sum, then divide by the mesh
    size), ``"sum"`` or ``"max"``; returns the tensor."""
    if _distributed(mesh):
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(tensor, op=red, group=mesh.group)
        if op == "mean":
            tensor.div_(mesh.size)
    return tensor


def gather(tensor: torch.Tensor, mesh: Optional[Mesh] = None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` joined along ``dim`` in rank order, on every
    rank, on the input's device (``process_allgather(..., tiled=True)``).
    Under gloo a CUDA tensor goes through the host."""
    if not _distributed(mesh):
        return tensor
    via_host = mesh.backend == "gloo" and tensor.is_cuda
    src = (tensor.cpu() if via_host else tensor).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=dim).to(tensor.device)
