"""Multi-process initialisation.

Port of gramtools_tpu/parallel/distributed.py: start
``torch.distributed`` once per process, with an explicit topology (no
cluster environment tells a program of its peers here). The backend is
``nccl`` when the engine's device (``GRAMTOOLS_TORCH_DEVICE``) is a CUDA
device and ``gloo`` on the CPU:

    from gramtools_tpu_torch.parallel.distributed import init_distributed
    init_distributed("tcp://host0:29500", num_processes=2, process_id=rank)

When no topology is given, ``torch.distributed``'s ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) are read;
where they are missing a warning is logged and the run goes on as a
single process, as the JAX package's does. Rank 0 runs the (host-side)
genotyping and output phase.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch.distributed as dist

from ..common.device import get_device

log = logging.getLogger("gramtools_tpu")


def backend_for_device() -> str:
    """``nccl`` for a CUDA engine device, ``gloo`` for the CPU."""
    return "nccl" if get_device().type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """torch.distributed.init_process_group with an optional explicit
    topology; coordinator_address is ``tcp://host:port``."""
    backend = backend_for_device()
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    try:
        dist.init_process_group(**kwargs)
        log.info("distributed runtime (%s): process %d of %d", backend,
                 dist.get_rank(), dist.get_world_size())
    except (RuntimeError, ValueError) as e:
        log.warning("torch.distributed.init_process_group failed/skipped: "
                    "%s", e)


def is_coordinator() -> bool:
    """True on rank 0, and in a run that is not distributed."""
    return not dist.is_initialized() or dist.get_rank() == 0
