"""Iterated box (average) filter: reference-exact uint8 and float modes.

Counterpart of ``raymarchdenoisercuda_tpu/ops/boxfilter.py``, the only
compute the CUDA reference ships (``filterKernelBaseline`` and
``filterKernelTiled``): a ``depth``-level iterated (2r+1)² uniform average
whose out-of-image taps are dropped.

* :func:`box_filter_u8` reproduces the reference bit for bit on
  interleaved uint8, with the truncating cast after every level and,
  optionally, the baseline kernel's grayscale quirk.  Plain PyTorch on any
  device (the JAX package has no kernel for it).
* :func:`box_filter` is the float path on planar planes and the plain twin
  of K10 (``ops/filters_cuda.py``'s ``box_filter_cuda``).
"""

from __future__ import annotations

import torch

from .common import shift2d, tap_offsets, valid_mask


def box_filter_u8(img: torch.Tensor, radius: int = 2, depth: int = 1,
                  grayscale_quirk: bool = False) -> torch.Tensor:
    """Reference-exact iterated average on interleaved uint8 (H, W, 3).

    ``grayscale_quirk=True`` writes the averaged red channel into all three
    (``filterKernelBaseline``); ``False`` keeps RGB (``filterKernelTiled``).
    Each level sums the in-range taps in float32, divides by their count and
    truncates to uint8, like the reference's per-level ``uchar4`` store."""
    H, W, _ = img.shape
    offs = tap_offsets(radius)
    norm = sum(valid_mask(H, W, dy, dx, device=img.device)
               for dy, dx in offs)
    x = img.permute(2, 0, 1)
    for _ in range(depth):
        xf = x.to(torch.float32)
        acc = torch.zeros_like(xf)
        for dy, dx in offs:
            acc = acc + shift2d(xf, dy, dx)
        x = (acc / norm).to(torch.uint8)   # truncating cast (values >= 0)
        if grayscale_quirk:
            x = x[:1].expand_as(x)
    return x.permute(1, 2, 0).contiguous()


def _sep_sum(v: torch.Tensor, radius: int, along_y: bool) -> torch.Tensor:
    acc = v
    for d in range(1, radius + 1):
        if along_y:
            acc = acc + shift2d(v, d, 0) + shift2d(v, -d, 0)
        else:
            acc = acc + shift2d(v, 0, d) + shift2d(v, 0, -d)
    return acc


def box_filter(x: torch.Tensor, radius: int = 2, depth: int = 1) -> torch.Tensor:
    """Float iterated box average on planar (..., H, W), separable: the
    numerator and the per-pixel tap count are both summed along y, then
    along x, and divided once a level (plain twin of K10)."""
    H, W = x.shape[-2:]
    ones = torch.ones((H, W), dtype=x.dtype, device=x.device)
    count = _sep_sum(_sep_sum(ones, radius, True), radius, False)
    for _ in range(depth):
        x = _sep_sum(_sep_sum(x, radius, True), radius, False) / count
    return x
