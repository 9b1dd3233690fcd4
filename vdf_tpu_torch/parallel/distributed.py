"""Multi-process entry: ``torch.distributed`` process groups (SURVEY §2.4).

Port of ``vdf_tpu.parallel.distributed``.  N processes, one device each,
form one process group; the sharded functions of parallel/mesh.py then run
over it, their collectives on NCCL between cards or on gloo between CPU
processes.  The code is the same at any N, one process included.

Usage (one call per process, before any collective):

    from vdf_tpu_torch.parallel import distributed, sharded_msm
    distributed.initialize("host0:29500", num_processes=N, process_id=k)
    mesh = distributed.global_mesh()          # every rank
    out = sharded_msm(curve, points, scalars, mesh)

``coordinator`` is ``host:port`` (a TCP store on rank 0's host) or a
``file://`` path that every process can reach (no TCP at all).  The rank's
device is ``device``, by default the card ``cuda:(process_id mod cards)``
(``KernelError`` where there is none; the CPU is asked for by name).  The
backend is NCCL for a CUDA device and gloo for the CPU unless one is named;
a failing NCCL raises and never falls back to gloo.

Tested with 2 gloo processes on the CPU in tests/test_torch_parallel.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device
from .mesh import SHARD_AXIS, Mesh, _block, make_mesh

_RANK_DEVICE: torch.device | None = None


def _device_for(process_id: int, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    default_device()  # KernelError where there is no card
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize(coordinator: str, num_processes: int, process_id: int, backend: str | None = None,
               device=None) -> None:
    """Join the process group (a second call in a process does nothing)."""
    import torch.distributed as dist

    global _RANK_DEVICE
    if dist.is_initialized():
        return
    dev = _device_for(process_id, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    _RANK_DEVICE = dev


def rank_device() -> torch.device:
    """This process's device: ``initialize``'s, or, for a group made
    another way, the card ``cuda:(rank mod cards)``."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    import torch.distributed as dist

    return _device_for(dist.get_rank(), None)


def global_mesh(axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over every rank of the process group, in rank order."""
    return make_mesh(None, axis)


def distribute(mesh: Mesh, host_array: np.ndarray, axis: str = SHARD_AXIS) -> torch.Tensor:
    """A host ndarray (the same on every rank) -> the rank's contiguous rows
    of it along dim 0, on the rank's device; no rank touches another's
    rows on its device."""
    rows = np.ascontiguousarray(host_array[_block(mesh, host_array.shape[0])])
    return torch.from_numpy(rows).to(mesh.device)


def replicate(mesh: Mesh, host_array: np.ndarray) -> torch.Tensor:
    """A host ndarray -> the whole of it on the rank's device."""
    return torch.from_numpy(np.ascontiguousarray(host_array)).to(mesh.device)
