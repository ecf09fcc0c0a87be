"""The data-parallel group (port of ``ealv_tpu/parallel/mesh.py``).

The JAX package lays a one-axis ``Mesh`` over its devices and runs one SPMD
program across it. The port runs one process per rank instead, each with
the whole replicated experiment, over a ``torch.distributed`` process group
that the caller has initialized: NCCL for CUDA tensors, gloo for CPU
tensors (gloo also reduces CUDA tensors, but only ``all_reduce`` and
``broadcast``, the only collectives the port uses). ``make_mesh`` picks no
backend itself: the group's backend is the caller's choice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data axis over ``size`` ranks: the process group (None: the
    default group), this process's rank in it, the device its tensors live
    on and the axis name."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device="cuda") -> Mesh:
    """The data axis over the first ``n_devices`` ranks of the initialized
    default group (default: all of them). Raises ``ValueError`` where
    ``n_devices`` exceeds the world size, where NCCL is asked to serve a
    non-CUDA device, and on a rank outside the first ``n_devices``. Every
    rank of the default group must call it (a smaller axis makes a new
    group, a collective call)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} ranks but the process group has {world} "
                         "(start one process per rank)")
    dev = torch.device(device)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL group reduces CUDA tensors only, not {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = None if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of the first {n} ranks")
    return Mesh(group=group, rank=rank, size=n, device=dev, axis_name=axis_name)
