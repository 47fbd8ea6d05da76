"""Process-group set-up for the sharded path (one rank a card).

Counterpart of ``raymarchdenoisercuda_tpu/parallel/distributed.py``, on
``torch.distributed``: :func:`initialize` joins the default process group
(NCCL where CUDA is present, gloo otherwise), after which
``parallel.mesh.make_mesh`` lays the ranks out as ('data', 'y', 'x').  A
process that never calls it runs the sharded functions on a (1, 1, 1) mesh.
:func:`spawn_group` starts a group of ranks on one host, one process a
rank, and gathers what a function returns on each.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

# the timeout of a spawned rank's rendezvous and of each of its collectives
COLLECTIVE_TIMEOUT_S = 120.0


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


def _rank_main(rank, world, backend, workdir, data, fn, kwargs):
    from .mesh import make_mesh

    result = {}
    try:
        torch.set_num_threads(1)
        initialize(backend, init_method=f"file://{workdir}/init",
                   world_size=world, rank=rank,
                   timeout_s=COLLECTIVE_TIMEOUT_S)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
        result = fn(make_mesh(world, data=data), device, **kwargs)
        dist.barrier()
    except BaseException:
        result = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_group(n: int, backend: str, fn: Callable[..., Dict],
                kwargs: Optional[Dict] = None, *, data: int = 1,
                join_timeout: float = 600.0,
                workdir: Optional[str] = None) -> List[Dict]:
    """Run ``fn(mesh, device, **kwargs)`` on a group of ``n`` ranks, one
    spawned process a rank (``backend`` "nccl": rank r on card r; "gloo":
    CPU ranks, one torch thread each), laid out by ``make_mesh(n, data=
    data)`` and joined through a file in a temporary directory (under
    ``workdir`` if given).  ``fn`` is a module-level function (a rank
    imports it by name) that returns a picklable dict; returns the ranks'
    dicts in rank order.  Rendezvous and collectives time out after
    :data:`COLLECTIVE_TIMEOUT_S`; ranks that outlive ``join_timeout``
    seconds are killed.  Raises with the ranks' tracebacks if one failed,
    hung or died."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            r, n, backend, tmp, data, fn, kwargs or {}), daemon=True)
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise RuntimeError(f"{fn.__name__} on {n} ranks: ranks {hung} "
                               f"still running after {join_timeout} s")
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"{fn.__name__} on {n} ranks: rank {r} "
                                   f"died (exit code {p.exitcode})")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    errors = [f"rank {r}:\n{res['error']}" for r, res in enumerate(results)
              if "error" in res]
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
