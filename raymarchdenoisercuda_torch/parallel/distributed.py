"""Process-group set-up for the sharded path (one rank a card).

Counterpart of ``raymarchdenoisercuda_tpu/parallel/distributed.py``, on
``torch.distributed``: :func:`initialize` joins the default process group
(NCCL where CUDA is present, gloo otherwise), after which
``parallel.mesh.make_mesh`` lays the ranks out as ('data', 'y', 'x').  A
process that never calls it runs the sharded functions on a (1, 1, 1) mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None, *,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 120.0) -> bool:
    """Join the default process group; idempotent (a second call is a
    no-op).  Returns whether a group exists afterwards.

    ``backend`` defaults to NCCL when CUDA is available, else gloo; with
    NCCL the rank takes card ``rank % device_count()``.  The group comes
    from the arguments or, failing them, from the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Given an
    explicit configuration (arguments or ``WORLD_SIZE`` in the
    environment), errors propagate: a misconfigured job fails loudly.
    Without any, the process stays alone (no group, a (1, 1, 1) mesh).
    ``timeout_s`` bounds every collective, so a hung peer fails the job
    instead of stalling it."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        if world_size is None and rank is None:
            return False
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def runtime_info() -> dict:
    """Process/device topology summary for logs and failure triage."""
    up = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "platform": "gpu" if cuda else "cpu",
    }
