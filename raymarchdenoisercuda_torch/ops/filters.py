"""Unified filter dispatch over ``FilterParams``: all four filter types.

Counterpart of ``raymarchdenoisercuda_tpu/ops/filters.py``.  The reference
declares ``FilterType {AVERAGE, GAUSSIAN, CROSS, WAVELET}`` but implements
only uniform weights; here every type is implemented:

* AVERAGE: the iterated box (``ops/boxfilter.py``; kernel K10);
* GAUSSIAN: a separable spatial gaussian (``sigma_space``), iterated
  ``depth`` times (:func:`gaussian_filter`; kernel K11);
* CROSS: a cross-bilateral filter, the spatial gaussian times edge-stopping
  terms on the albedo, normal and depth guidance planes
  (:func:`cross_bilateral_filter`; kernel K12);
* WAVELET: the edge-aware à-trous SVGF sweep (``ops/atrous.py``; kernel K1).

:func:`apply_filter` is the GBuffer-in, GBuffer-out entry point of the
reference's ``filterKernel*(GBuffer, FilterParams)``.  ``impl="auto"`` goes
through the kernel wrappers (``ops/filters_cuda.py``, ``ops/atrous_cuda.py``),
which launch the CUDA kernels for CUDA tensors and run the plain versions
below for CPU tensors; ``impl="plain"`` runs the plain versions on any
device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import FilterParams, FilterType, SVGFParams
from ..gbuffer import GBuffer
from .atrous import _EPS, atrous_level_ref, svgf_spatial_ref
from .boxfilter import box_filter
from .common import finite_diff_gradients, shift2d, valid_mask


def _gauss_taps(radius: int, sigma: float) -> Tuple[float, ...]:
    t = [math.exp(-0.5 * (i / max(sigma, 1e-6)) ** 2)
         for i in range(-radius, radius + 1)]
    s = sum(t)
    return tuple(v / s for v in t)


def gaussian_filter(x: torch.Tensor, radius: int = 2, sigma: float = 2.0,
                    depth: int = 1) -> torch.Tensor:
    """Separable spatial gaussian on planar (..., H, W), iterated ``depth``
    times: a pass along y, then along x, each divided by the sum of its
    in-range tap weights (plain twin of K11)."""
    H, W = x.shape[-2:]
    taps = _gauss_taps(radius, sigma)

    def one_axis(v, along_y):
        num = torch.zeros_like(v)
        den = torch.zeros((H, W), dtype=v.dtype, device=v.device)
        for i, t in enumerate(taps):
            d = i - radius
            dy, dx = (d, 0) if along_y else (0, d)
            m = valid_mask(H, W, dy, dx, device=v.device, dtype=v.dtype)
            num = num + t * m * shift2d(v, dy, dx)
            den = den + t * m
        return num / den

    for _ in range(depth):
        x = one_axis(one_axis(x, True), False)
    return x


def cross_bilateral_filter(
    color: torch.Tensor,        # (3, H, W)
    albedo: torch.Tensor,       # (3, H, W)
    normal: torch.Tensor,       # (3, H, W)
    depth: torch.Tensor,        # (H, W)
    *,
    params: FilterParams = FilterParams(type=FilterType.CROSS),
) -> torch.Tensor:
    """Cross-bilateral filter guided by the G-buffer (plain twin of K12).

    Tap weight: gaussian(spatial; sigma_space) × exp(−|Δalbedo|²/2σa²) ×
    max(n·n′, 0)^σn × exp(−|Δz|/σz); output num / max(den, 1e-8)."""
    H, W = depth.shape
    r = params.radius
    gt = _gauss_taps(r, params.sigma_space)
    num = torch.zeros_like(color)
    den = torch.zeros_like(depth)
    inv_2sa2 = 1.0 / (2.0 * params.sigma_albedo ** 2 + _EPS)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g = gt[dy + r] * gt[dx + r]
            m = valid_mask(H, W, dy, dx, device=depth.device,
                           dtype=depth.dtype)
            a_q = shift2d(albedo, dy, dx)
            n_q = shift2d(normal, dy, dx)
            z_q = shift2d(depth, dy, dx)
            wa = torch.exp(-((albedo - a_q) ** 2).sum(0) * inv_2sa2)
            ndot = torch.clamp((normal * n_q).sum(0), min=0.0)
            wn = torch.pow(torch.clamp(ndot, min=1e-20), params.sigma_normal)
            wz = torch.exp(-torch.abs(depth - z_q)
                           / (params.sigma_depth + _EPS))
            w = g * m * wa * wn * wz
            num = num + w[None] * shift2d(color, dy, dx)
            den = den + w
    return num / torch.clamp(den, min=_EPS)[None]


def apply_filter(
    gbuf: GBuffer,
    params: FilterParams,
    variance: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
) -> GBuffer:
    """Filter ``gbuf.render`` by ``params.type`` -> the GBuffer with
    ``denoised`` set.  ``params.level`` (the à-trous starting level, applying
    levels [level, level + depth)) is for WAVELET only; any other type with
    a nonzero level raises ``ValueError``.  WAVELET without ``variance``
    filters with unit variance."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl: {impl!r}")
    t = params.type
    if params.level != 0 and t != FilterType.WAVELET:
        raise ValueError(
            f"FilterParams.level={params.level} is only meaningful for "
            f"WAVELET (à-trous dilation); got type={t}")
    kernels = impl == "auto"
    if kernels:
        # imported here: the wrappers' modules import this one
        from .atrous_cuda import atrous_level_cuda, svgf_spatial_cuda, zgrad_cuda
        from .filters_cuda import (box_filter_cuda, cross_bilateral_cuda,
                                   gaussian_filter_cuda)
    render = gbuf.render
    if t == FilterType.AVERAGE:
        box = box_filter_cuda if kernels else box_filter
        out = box(render, radius=params.radius, depth=params.depth)
    elif t == FilterType.GAUSSIAN:
        gauss = gaussian_filter_cuda if kernels else gaussian_filter
        out = gauss(render, radius=params.radius, sigma=params.sigma_space,
                    depth=params.depth)
    elif t == FilterType.CROSS:
        cross = cross_bilateral_cuda if kernels else cross_bilateral_filter
        out = render
        for _ in range(params.depth):
            out = cross(out, gbuf.albedo, gbuf.normal, gbuf.depth,
                        params=params)
    elif t == FilterType.WAVELET:
        sp = SVGFParams(
            iterations=params.depth, radius=params.radius,
            sigma_color=params.sigma_color, sigma_normal=params.sigma_normal,
            sigma_depth=params.sigma_depth)
        var = variance if variance is not None else torch.ones_like(gbuf.depth)
        if params.level == 0:
            sweep = svgf_spatial_cuda if kernels else svgf_spatial_ref
            out, _ = sweep(render, var, gbuf.normal, gbuf.depth, params=sp)
        else:
            level = atrous_level_cuda if kernels else atrous_level_ref
            zgrad = (zgrad_cuda if kernels else finite_diff_gradients)(
                gbuf.depth)
            c, v = render, var
            for i in range(params.depth):
                c, v = level(c, v, gbuf.normal, gbuf.depth, zgrad,
                             level=params.level + i, params=sp)
            out = c
    else:  # pragma: no cover
        raise ValueError(f"unknown filter type {t}")
    return gbuf.replace(denoised=out)
