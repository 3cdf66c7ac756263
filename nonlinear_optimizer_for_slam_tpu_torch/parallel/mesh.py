"""The factor mesh: this process's place in a ``torch.distributed`` group.

The reference's execution substrate is a CPU thread pool with optional core
pinning (multi_thread_executor.h:126-167). The JAX package lays devices out
on a 1-D ``jax.sharding.Mesh`` over the factor axis, one controller for
all of them. The port uses PyTorch's idiom instead: one process per rank
over a ``torch.distributed`` process group, SPMD. Every rank makes the
same call with the full data; correspondences or edges are padded to a
multiple of the world size, each rank evaluates its own contiguous block of
rows, and the small (H, g, cost) partials are summed across ranks
(``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

FACTOR_AXIS = "factors"


@dataclasses.dataclass(frozen=True)
class FactorMesh:
    """This rank of a process group, and the device its shard lives on.

    ``group`` is None for the default group; ``backend`` ("gloo", "nccl")
    is None for a world of one made without a process group, where nothing
    is exchanged. ``host_staged``
    is true when the group's backend is gloo and the device is a GPU: the
    partials then go through host memory for the exchange."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]

    @property
    def devices(self) -> np.ndarray:
        """One entry per rank: ``mesh.devices.size`` is the world size, as
        JAX callers read it."""
        return np.arange(self.size)

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


def make_factor_mesh(group: Optional[dist.ProcessGroup] = None, device="cuda") -> FactorMesh:
    """The mesh over the ranks of ``group`` (default: the default process
    group). Without an initialized process group it is a world of one.

    This plays the role of ``MultiThreadExecutor(num_threads)``
    (multi_thread_executor.h:51-56): instead of spawning worker threads,
    each rank is a process and the collectives join them. ``device``
    defaults to this process's current CUDA device."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not initialized")
        return FactorMesh(None, 0, 1, device, None)
    return FactorMesh(
        group, dist.get_rank(group), dist.get_world_size(group), device,
        str(dist.get_backend(group)),
    )


def factor_sharding(mesh: FactorMesh, num_rows: int) -> slice:
    """This rank's contiguous block of ``num_rows`` rows (the factor axis,
    axis 0); ``num_rows`` must be a multiple of the world size."""
    if num_rows % mesh.size:
        raise ValueError(f"{num_rows} rows do not split over {mesh.size} ranks; pad them first")
    block = num_rows // mesh.size
    return slice(mesh.rank * block, (mesh.rank + 1) * block)
