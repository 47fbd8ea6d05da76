"""Shared stencil helpers for the plain image-space filters.

Counterpart of ``raymarchdenoisercuda_tpu/ops/common.py``.  Out-of-range taps
are dropped: a shifted-out sample reads zero, and callers give it zero
weight, so normalisation divides by the sum of surviving weights only.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
