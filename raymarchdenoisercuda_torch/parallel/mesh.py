"""The ('data', 'y', 'x') mesh of ranks for spatial (tile) sharding.

Counterpart of ``raymarchdenoisercuda_tpu/parallel/mesh.py``.  Each rank of
the default process group owns one tile: 'y' and 'x' split the image rows
and columns, 'data' splits independent Monte-Carlo slices (each slice
renders the whole image with its own noise and history).  Rank ``r`` sits
at ``(d, iy, ix)`` with ``r = (d·ny + iy)·nx + ix``, the order of
``devices.reshape(data, ny, nx)`` in the JAX package.  With no process
group the mesh is (1, 1, 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "y", "x")


def factor2(n: int) -> Tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the extents ``shape`` = (data, ny, nx),
    its ``coords`` (d, iy, ix), and the process groups of its data slice
    (``spatial_group``: the ny·nx ranks that tile one image) and of its
    tile position (``data_group``: the ``data`` ranks that hold the same
    tile); a group is None where it would hold this rank alone or no
    process group exists."""

    shape: Tuple[int, int, int]
    coords: Tuple[int, int, int]
    spatial_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(AXES, self.shape))

    @property
    def rank(self) -> int:
        return self.rank_of(*self.coords)

    def rank_of(self, d: int, iy: int, ix: int) -> int:
        _, ny, nx = self.shape
        return (d * ny + iy) * nx + ix

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def tile_shape(self, Hg: int, Wg: int) -> Tuple[int, int]:
        """(th, tw) of the tiles of an Hg x Wg image (ceil division: a
        non-divisible image is padded to the mesh, see
        ``sharded.svgf_spatial_sharded``)."""
        _, ny, nx = self.shape
        return -(-Hg // ny), -(-Wg // nx)


def make_mesh(n_devices: Optional[int] = None, *, data: int = 1) -> Mesh:
    """The ('data', 'y', 'x') mesh over the ranks of the default process
    group (none: one rank).  ``n_devices`` must be that world size when
    given.  The spatial axes get a near-square factorization of
    n_devices/data, which minimises the halo perimeter for a fixed tile
    area.  Creating the groups is a collective: every rank calls it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks (one tile a rank)")
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"data={data}")
    ny, nx = factor2(n_devices // data)
    shape = (data, ny, nx)
    coords = (rank // (ny * nx), (rank // nx) % ny, rank % nx)
    spatial = data_grp = None
    if world > 1:
        # new_group is collective over the whole world: every rank creates
        # every group, in the same order, and keeps its own
        for d in range(data):
            g = dist.new_group([(d * ny * nx) + k for k in range(ny * nx)])
            if d == coords[0] and ny * nx > 1:
                spatial = g
        for k in range(ny * nx):
            g = dist.new_group([d * ny * nx + k for d in range(data)])
            if k == coords[1] * nx + coords[2] and data > 1:
                data_grp = g
        # one collective on the default group with every rank: NCCL sets
        # its communicator up here (a batch of point-to-point operations
        # must not be the first call that does it)
        nccl = dist.get_backend() == "nccl"
        dist.all_reduce(torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device()) if nccl else "cpu"))
    return Mesh(shape, coords, spatial, data_grp)


def tile_slices(mesh: Mesh, th: int, tw: int):
    """(row slice, column slice) of this rank's tile in the global image."""
    _, iy, ix = mesh.coords
    return slice(iy * th, (iy + 1) * th), slice(ix * tw, (ix + 1) * tw)


def shard_plane(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's tile of a global (…, Hg, Wg) plane (the JAX package's
    ``plane_pspec``/``gbuffer_pspec`` sharding), as a contiguous tensor;
    Hg and Wg must divide over the mesh."""
    Hg, Wg = x.shape[-2:]
    _, ny, nx = mesh.shape
    if Hg % ny or Wg % nx:
        raise ValueError(f"({Hg}, {Wg}) does not tile over the ({ny}, {nx}) "
                         f"mesh")
    rows, cols = tile_slices(mesh, Hg // ny, Wg // nx)
    return x[..., rows, cols].contiguous()


def unshard_plane(mesh: Mesh, tile: torch.Tensor) -> torch.Tensor:
    """The global (…, ny·th, nx·tw) plane of this rank's data slice from
    every rank's tile (an all-gather over the slice's ranks)."""
    _, ny, nx = mesh.shape
    if ny * nx == 1:
        return tile
    tile = tile.contiguous()
    parts = [torch.empty_like(tile) for _ in range(ny * nx)]
    dist.all_gather(parts, tile, group=mesh.spatial_group)
    rows = [torch.cat(parts[iy * nx:(iy + 1) * nx], dim=-1)
            for iy in range(ny)]
    return torch.cat(rows, dim=-2)
