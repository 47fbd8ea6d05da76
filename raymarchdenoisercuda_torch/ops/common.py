"""Shared stencil helpers for the plain image-space filters.

Counterpart of ``raymarchdenoisercuda_tpu/ops/common.py``.  Out-of-range taps
are dropped: a shifted-out sample reads zero, and callers give it zero
weight, so normalisation divides by the sum of surviving weights only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Tile:
    """Where a tile lies in the frame: the global pixel of its (0, 0) and
    the frame's (height, width).  The tile forms of the stencils drop a tap
    whose GLOBAL coordinate falls outside the frame, so a tile computes at
    its pixels what the whole frame computes there; the planes a stencil
    reads around a pixel come as canvases, the tile plus a margin of m
    pixels on every side that holds the neighbouring tiles' pixels (the
    halo exchange fills it, ``parallel/halo.py``)."""

    origin: Tuple[int, int]
    bounds: Tuple[int, int]


def canvas_margin(x: torch.Tensor, H: int, W: int, name: str) -> int:
    """The margin m of a (…, H + 2m, W + 2m) canvas around an H x W tile."""
    h, w = x.shape[-2:]
    m = (h - H) // 2
    if h != H + 2 * m or w != W + 2 * m or m < 0:
        raise ValueError(f"{name}: shape {tuple(x.shape)} is not an "
                         f"{H}x{W} tile with an equal margin on every side")
    return m


def crop(x: torch.Tensor, m: int, dy: int, dx: int, H: int,
         W: int) -> torch.Tensor:
    """The H x W window of a canvas with margin m at offset (dy, dx) from
    the tile: ``crop(x, m, dy, dx, H, W)[..., i, j] = tile pixel (i+dy,
    j+dx)`` (a view)."""
    return x[..., m + dy:m + dy + H, m + dx:m + dx + W]


def frame_canvas(x: torch.Tensor, tile: Tile, H: int, W: int,
                 m: int) -> torch.Tensor:
    """The canvas of the H x W tile ``tile`` cut from the whole (…, Hg, Wg)
    frame ``x``: the tile and m of the frame's pixels on every side, zeros
    past its border, which is what the halo exchange delivers."""
    gy0, gx0 = tile.origin
    xp = F.pad(x, (m, m, m, m))
    return xp[..., gy0:gy0 + H + 2 * m, gx0:gx0 + W + 2 * m].contiguous()


def global_mask(tile: Tile, H: int, W: int, dy: int, dx: int, *, device,
                dtype=torch.float32) -> torch.Tensor:
    """(H, W) mask of tile pixels whose (dy, dx)-shifted neighbour lies in
    the frame (the tile form of :func:`valid_mask`)."""
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    iy = torch.arange(gy0 + dy, gy0 + dy + H, device=device)[:, None]
    ix = torch.arange(gx0 + dx, gx0 + dx + W, device=device)[None, :]
    return ((iy >= 0) & (iy < Hg) & (ix >= 0) & (ix < Wg)).to(dtype)


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``y[..., i, j] = x[..., i+dy, j+dx]``, zero where out of range."""
    if dy == 0 and dx == 0:
        return x
    H, W = x.shape[-2], x.shape[-1]
    # F.pad takes (left, right, top, bottom) for the last two dims
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    ys, xs = max(dy, 0), max(dx, 0)
    return xp[..., ys:ys + H, xs:xs + W]


def valid_mask(H: int, W: int, dy: int, dx: int, *, device,
               dtype=torch.float32) -> torch.Tensor:
    """(H, W) mask of pixels whose (dy, dx)-shifted neighbour is in the image."""
    iy = torch.arange(H, device=device)[:, None]
    ix = torch.arange(W, device=device)[None, :]
    rm = (iy + dy >= 0) & (iy + dy < H)
    cm = (ix + dx >= 0) & (ix + dx < W)
    return (rm & cm).to(dtype)


def tap_offsets(radius: int, spacing: int = 1) -> Tuple[Tuple[int, int], ...]:
    """(dy, dx) offsets of a (2r+1)^2 footprint with à-trous dilation."""
    r = radius
    return tuple((dy * spacing, dx * spacing)
                 for dy in range(-r, r + 1) for dx in range(-r, r + 1))


def finite_diff_gradients(z: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient of an (H, W) plane -> (2, H, W) (dz/dy,
    dz/dx); one-sided at the borders."""
    H, W = z.shape
    fwd_y = shift2d(z, 1, 0) - z
    bwd_y = z - shift2d(z, -1, 0)
    fwd_x = shift2d(z, 0, 1) - z
    bwd_x = z - shift2d(z, 0, -1)
    iy = torch.arange(H, device=z.device)[:, None]
    ix = torch.arange(W, device=z.device)[None, :]
    dzdy = torch.where(iy == 0, fwd_y,
                       torch.where(iy == H - 1, bwd_y, 0.5 * (fwd_y + bwd_y)))
    dzdx = torch.where(ix == 0, fwd_x,
                       torch.where(ix == W - 1, bwd_x, 0.5 * (fwd_x + bwd_x)))
    return torch.stack([dzdy, dzdx])


def tent(x: torch.Tensor) -> torch.Tensor:
    """The bilinear tap weight ``max(0, 1 − |x|)``."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def tent_prime(x: torch.Tensor) -> torch.Tensor:
    """d/dx ``max(0, 1 − |x|)`` with JAX's kink conventions (the JAX
    package's ``_tent_prime``): ``−sign(x)`` with sign(0) = +1 inside the
    support, half of it at the ``|x| = 1`` ties, zero outside.  Autograd of
    ``tent`` gives 0 at x = 0 and ∓1 at ±1 instead."""
    a = torch.abs(x)
    sgn = torch.where(x >= 0, 1.0, -1.0)
    w = torch.where(a < 1.0, 1.0, torch.where(a == 1.0, 0.5, 0.0))
    return -sgn * w


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once, as a fused multiply-add rounds it (a float32
    product is exact in float64, and the sum is rounded to float32 from
    there).

    The reference's compiled code fuses such multiply-adds, and the CUDA
    kernel writes them as ``fmaf``; the plain temporal step uses this in
    the reprojection sum, whose rounding decides the reprojected history
    length that integer-valued tests read downstream."""
    return (a.double() * b.double() + c.double()).to(a.dtype)
