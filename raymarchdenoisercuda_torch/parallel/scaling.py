"""Weak-scaling harness for the sharded SVGF sweep (BASELINE.md config 5).

Counterpart of ``raymarchdenoisercuda_tpu/parallel/scaling.py``.  Weak
scaling: each rank's tile stays the same while ranks are added (the global
frame grows with them), so ideal scaling keeps the time a step flat; the
efficiency at N ranks is t(1) / t(N).  A step is the 5-level sweep of
``parallel.sharded.svgf_spatial_local`` on the rank's tile, forward and,
by default, backward (the gradient of Σ c² + Σ v with respect to the
tile's colour), the halo exchanged between the ranks.

:func:`time_sharded_step` is a collective of the ranks of one process
group (one tile a rank; no group: the (1, 1, 1) mesh of one process).
:func:`weak_scaling` runs it on one group a rank count: in this process
for one rank, else in processes that ``parallel.distributed.spawn_group``
starts (on the card: NCCL, one card a rank, and more ranks than the host
has cards raise; on the CPU: gloo ranks), and returns one row a count.
Rows from CPU ranks are marked ``"validates": "layout-only"``: those
ranks share one host's cores, so their times say nothing of cards joined
by NVLink; they show that the sharded program runs at every mesh shape.

    python -m raymarchdenoisercuda_torch.parallel.scaling --tile 256
    python -m raymarchdenoisercuda_torch.parallel.scaling --cpu 4 --tile 64
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import SVGFParams
from ..device import resolve_device
from .distributed import spawn_group
from .mesh import Mesh, factor2, make_mesh
from .sharded import svgf_spatial_local

Tile = Union[int, Tuple[int, int]]


def _tile_shape(tile: Tile) -> Tuple[int, int]:
    return (tile, tile) if isinstance(tile, int) else tuple(tile)


def _inputs(th: int, tw: int, coords, device, seed: int = 0):
    """Seeded colour, variance, normal and depth of one tile, drawn per
    tile (a rank needs no other rank's pixels)."""
    rng = np.random.default_rng([seed, *coords])
    n = rng.standard_normal((3, th, tw)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return (t(rng.random((3, th, tw))), t(0.02 * rng.random((th, tw))),
            t(n), t(0.3 + 0.5 * rng.random((th, tw))))


def time_sharded_step(mesh: Mesh, tile: Tile = 256, iterations: int = 5,
                      backward: bool = True, steps: int = 5,
                      impl: str = "auto", device=None) -> float:
    """Seconds a fwd(+bwd) step of the sweep with a ``tile`` (side, or
    (rows, columns)) of pixels on every rank of ``mesh``: the median of
    ``steps`` timed steps after two untimed ones, the slowest rank's.
    ``impl`` as ``svgf_spatial_local``'s ("auto": the kernels on the card,
    "plain": the oracle path).  A collective: every rank calls it."""
    device = resolve_device(device)
    th, tw = _tile_shape(tile)
    _, ny, nx = mesh.shape
    Hg, Wg = th * ny, tw * nx
    color, variance, normal, depth = _inputs(th, tw, mesh.coords, device)
    params = SVGFParams(iterations=iterations)
    cuda = device.type == "cuda"
    if not cuda and impl == "auto":
        impl = "plain"

    def step():
        c = color.clone().requires_grad_(backward)
        oc, ov = svgf_spatial_local(c, variance, normal, depth, Hg, Wg,
                                    mesh=mesh, params=params, impl=impl)
        if backward:
            torch.autograd.grad((oc * oc).sum() + ov.sum(), c)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
        if dist.is_initialized():
            dist.barrier()

    times = []
    for k in range(2 + steps):
        sync()
        t0 = time.perf_counter()
        step()
        if cuda:
            torch.cuda.synchronize(device)
        if k >= 2:
            times.append(time.perf_counter() - t0)
    t = torch.tensor([float(np.median(times))], dtype=torch.float64,
                     device=device if cuda else "cpu")
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _row(n: int, tile: Tile, seconds: float, platform: str,
         virtual: bool) -> Dict:
    th, tw = _tile_shape(tile)
    row = {"devices": n, "mesh": factor2(n), "tile": [th, tw],
           "platform": platform, "sec_per_step": seconds,
           "mpix_per_s": n * th * tw / seconds / 1e6}
    if virtual:
        row["validates"] = "layout-only"
        row["caveat"] = ("ranks share one host's cores; weak_efficiency "
                         "does not predict scaling over cards")
    return row


def _step_rank(mesh: Mesh, device, **kw) -> Dict:
    """A spawned rank's part of :func:`weak_scaling`."""
    return {"seconds": time_sharded_step(mesh, device=device, **kw)}


def weak_scaling(device_counts: Sequence[int], tile: Tile = 256,
                 iterations: int = 5, backward: bool = True,
                 steps: int = 5, impl: str = "auto",
                 device=None) -> List[Dict]:
    """One row a rank count: its seconds a step, Mpix/s over the global
    frame and ``weak_efficiency`` = t(first count) / t(count).  One rank
    runs in this process on ``device``; N > 1 ranks run in a spawned group:
    NCCL over the host's first N cards where ``device`` is a card (more
    than it has raise), N gloo CPU ranks where it is the CPU."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and max(device_counts) > torch.cuda.device_count():
        raise ValueError(f"{max(device_counts)} ranks on the card: this host "
                         f"has {torch.cuda.device_count()}; CPU ranks run "
                         f"with device='cpu' (--cpu N)")
    kw = dict(tile=tile, iterations=iterations, backward=backward,
              steps=steps, impl=impl)
    rows = []
    t1: Optional[float] = None
    for n in device_counts:
        if n == 1:
            t = time_sharded_step(make_mesh(1), device=device, **kw)
        else:
            t = spawn_group(n, "nccl" if cuda else "gloo", _step_rank,
                            kw)[0]["seconds"]
        t1 = t if t1 is None else t1
        row = _row(n, tile, t, "gpu" if cuda else "cpu", virtual=not cuda)
        row["weak_efficiency"] = t1 / t
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", type=int, nargs="+", default=[256],
                    help="a rank's tile: side, or rows and columns")
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="rank counts (default: 1, 2, 4, 8 up to the "
                         "host's cards)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--impl", default="auto", choices=("auto", "plain"))
    ap.add_argument("--cpu", type=int, metavar="N", default=0,
                    help="N gloo CPU ranks (1, 2, 4 up to N): layout only")
    args = ap.parse_args(argv)
    tile = args.tile[0] if len(args.tile) == 1 else tuple(args.tile[:2])
    if args.cpu:
        device = torch.device("cpu")
        avail = args.cpu
    else:
        device = resolve_device(None)
        avail = torch.cuda.device_count()
    counts = args.devices or [n for n in (1, 2, 4, 8) if n <= avail]
    for row in weak_scaling(counts, tile, args.iterations,
                            backward=not args.fwd_only, steps=args.steps,
                            impl=args.impl, device=device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
