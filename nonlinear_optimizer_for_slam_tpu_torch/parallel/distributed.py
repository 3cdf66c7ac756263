"""Multi-process initialization and the global factor mesh.

The reference is single-process (SURVEY section 2.8: its only
"communication" is std::future hand-off between threads). The port scales
out as PyTorch programs do:

  1. start one process per GPU (``torchrun``, or any launcher that gives
     each process its rank), and in each call :func:`initialize`
     (``torch.distributed.init_process_group`` with a retry loop);
  2. build the factor mesh over every rank (:func:`make_global_factor_mesh`);
  3. hand the mesh to a minimizer, registrar or pose-graph solver: each
     rank evaluates its block of factors, the partials are summed across
     ranks, and the LM control flow stays replicated.

NCCL is the default backend when a GPU is present (each rank owns a
card); gloo runs on the CPU, and over the GPU with host-staged partials
when ranks share a card, which NCCL refuses.

Failure handling: :func:`initialize` retries transient rendezvous errors;
there is no elastic recovery, matching the reference's none (SURVEY
section 5).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import FactorMesh, make_factor_mesh


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    retries: int = 3,
    retry_delay_s: float = 5.0,
) -> None:
    """``torch.distributed.init_process_group`` with retry; a no-op for a
    world of one.

    ``world_size`` and ``rank`` default to the ``WORLD_SIZE`` and ``RANK``
    environment variables (``torchrun``'s), ``init_method`` to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``); give ``tcp://host:port`` or
    ``file://path`` otherwise. ``backend`` defaults to "nccl" with a GPU,
    "gloo" without; under NCCL this process takes the GPU of its
    ``LOCAL_RANK`` (default: rank modulo the GPUs). Call once per process
    before any collective."""
    if world_size is None:
        env = os.environ.get("WORLD_SIZE")
        world_size = int(env) if env else None
    if world_size is None or world_size == 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else rank % torch.cuda.device_count())
    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=init_method or "env://", world_size=world_size, rank=rank
            )
            return
        except (RuntimeError, ValueError) as e:  # rendezvous races at bring-up
            last = e
            time.sleep(retry_delay_s * (attempt + 1))
    raise RuntimeError(
        f"torch.distributed.init_process_group failed after {retries} tries: {last}"
    )


def make_global_factor_mesh(device="cuda") -> FactorMesh:
    """1-D factor mesh over every rank of the default process group (a
    world of one without one)."""
    return make_factor_mesh(None, device)


def process_info() -> dict:
    """Process placement summary for logs, under the JAX package's keys."""
    if dist.is_initialized():
        index, count, backend = dist.get_rank(), dist.get_world_size(), str(dist.get_backend())
    else:
        index, count, backend = 0, 1, None
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "process_index": index,
        "process_count": count,
        "local_devices": local,
        "global_devices": count,
        "backend": backend,
    }
