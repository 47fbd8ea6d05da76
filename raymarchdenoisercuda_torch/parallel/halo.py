"""Halo exchange between neighbouring tiles, over ``torch.distributed``.

Counterpart of ``raymarchdenoisercuda_tpu/parallel/halo.py``, where
``lax.ppermute`` moves the strips.  Here each rank sends its edge rows (or
columns) to the ranks next to it on the mesh's 'y' (or 'x') ring and
receives theirs, with ``dist.batch_isend_irecv``.  The rings are not
cyclic: a tile on the image border gets zeros, which is the reference's
dropped-tap ``inRange`` semantics (src/filter.cu:37-38).  A halo wider than
the tile takes several hops (hop k reads the tile k places away), which a
deep à-trous level needs when its dilated footprint exceeds the tile.

The exchange is differentiable: its backward sends each halo strip's
cotangent back to the tile that owns the strip, where it is added to the
edge rows or columns it came from (the transpose that ``ppermute`` gives
JAX for free).  An axis of extent 1 needs no communication at all: both
neighbours are the border, so the halo is a zero pad (and its adjoint a
crop).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh

_AXIS = {"y": 1, "x": 2}


def _peer(mesh: Mesh, axis: str, k: int) -> int:
    """Global rank of the tile k places along ``axis`` (-1: none)."""
    d, iy, ix = mesh.coords
    coords = [d, iy, ix]
    a = _AXIS[axis]
    coords[a] += k
    if not 0 <= coords[a] < mesh.shape[a]:
        return -1
    return mesh.rank_of(*coords)


def _hops(L: int, halo: int) -> List[int]:
    """Rows (or columns) taken from the tile k = 1, 2, … places away."""
    takes, remaining = [], halo
    while remaining > 0:
        takes.append(min(L, remaining))
        remaining -= takes[-1]
    return takes


def _swap(sends, recvs) -> None:
    """Post every send and receive as one batch and wait for all of them.
    ``sends``/``recvs``: lists of (tensor, peer rank)."""
    ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _exchange(x: torch.Tensor, halo: int, mesh: Mesh, axis: str,
              dim: int) -> torch.Tensor:
    L = x.shape[dim]
    before, after, sends, recvs = [], [], [], []
    for k, take in enumerate(_hops(L, halo), start=1):
        shape = list(x.shape)
        shape[dim] = take
        for sign, chunks in ((-1, before), (1, after)):
            peer = _peer(mesh, axis, sign * k)
            buf = (torch.zeros if peer < 0 else torch.empty)(
                shape, dtype=x.dtype, device=x.device)
            if peer >= 0:
                # my head goes to the tile before me (its after-halo), my
                # tail to the tile after me (its before-halo)
                part = (x.narrow(dim, 0, take) if sign < 0
                        else x.narrow(dim, L - take, take))
                sends.append((part.contiguous(), peer))
                recvs.append((buf, peer))
            if sign < 0:
                chunks.insert(0, buf)       # farthest chunk first
            else:
                chunks.append(buf)
    _swap(sends, recvs)
    return torch.cat(before + [x] + after, dim=dim)


def _exchange_adjoint(g: torch.Tensor, halo: int, mesh: Mesh, axis: str,
                      dim: int, L: int) -> torch.Tensor:
    takes = _hops(L, halo)
    dx = g.narrow(dim, halo, L).clone()
    sends, recvs, adds = [], [], []
    off_before = halo
    off_after = halo + L
    for k, take in enumerate(takes, start=1):
        off_before -= take
        for sign in (-1, 1):
            peer = _peer(mesh, axis, sign * k)
            if peer < 0:
                continue
            if sign < 0:
                # the before-halo chunk k is the tail of the tile k before
                sends.append((g.narrow(dim, off_before, take).contiguous(),
                              peer))
                buf = torch.empty_like(dx.narrow(dim, 0, take))
                recvs.append((buf, peer))
                adds.append((0, buf))       # its after-chunk: my head
            else:
                sends.append((g.narrow(dim, off_after, take).contiguous(),
                              peer))
                buf = torch.empty_like(dx.narrow(dim, 0, take))
                recvs.append((buf, peer))
                adds.append((L - take, buf))   # its before-chunk: my tail
        off_after += take
    _swap(sends, recvs)
    for start, buf in adds:
        dx.narrow(dim, start, buf.shape[dim]).add_(buf)
    return dx


class _ExchangeAxis(torch.autograd.Function):
    """One axis of the halo exchange, with the transposed exchange as its
    backward."""

    @staticmethod
    def forward(ctx, x, halo, mesh, axis, dim):
        ctx.args = (halo, mesh, axis, dim, x.shape[dim])
        return _exchange(x, halo, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_adjoint(g.contiguous(), *ctx.args), None, None,
                None, None)


def _exchange_axis(x: torch.Tensor, halo: int, mesh: Mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """Pad the tile with ``halo`` elements from its neighbours along one
    axis (zeros past the image border)."""
    if halo == 0:
        return x
    if mesh.shape[_AXIS[axis]] == 1:
        pad = [0, 0] * (x.dim() - dim - 1) + [halo, halo]
        return F.pad(x, pad)
    return _ExchangeAxis.apply(x, halo, mesh, axis, dim)


def exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (…, H, W) tile with ``halo`` rows from its 'y' neighbours ->
    (…, H + 2h, W)."""
    return _exchange_axis(x, halo, mesh, "y", x.dim() - 2)


def exchange_cols(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (…, H, W) tile with ``halo`` columns from its 'x' neighbours
    -> (…, H, W + 2h)."""
    return _exchange_axis(x, halo, mesh, "x", x.dim() - 1)


def exchange_halo2d(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """The full 2-D halo (rows, then columns of the row-padded tile, which
    brings the corners from the diagonal neighbours) -> (…, H + 2h,
    W + 2h)."""
    return exchange_cols(exchange_rows(x, halo, mesh), halo, mesh)


def tile_origin(local_shape: Tuple[int, int], mesh: Mesh) -> Tuple[int, int]:
    """Global (row0, col0) of this rank's tile."""
    _, iy, ix = mesh.coords
    return iy * local_shape[0], ix * local_shape[1]
