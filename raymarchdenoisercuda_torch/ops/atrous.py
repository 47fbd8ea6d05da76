"""Edge-aware à-trous wavelet filter (SVGF spatial pass): the plain PyTorch
version.

Counterpart of ``raymarchdenoisercuda_tpu/ops/atrous.py`` (detached weights:
this slice is forward-only).  It is the CPU path and the oracle that the
CUDA kernel K1 (``ops/cuda/atrous.cu``) is held against on the card; it is
never a fallback for a CUDA tensor.

Per level, at tap spacing ``s = 2^level``, for centre p and tap q = p + s·d:

* ``h(d) = taps[dy]·taps[dx]`` (B3 spline for radius 2, binomial otherwise);
* ``w = h · exp(−|z_p−z_q| / (σz·|∇z_p·(q−p)| + ε) − |l_p−l_q| / σden_p)
  · max(n_p·n_q, 0)^σn`` with ``σden = σl·sqrt(blur3x3(var)) + ε``;
* colour ``Σ w c_q / N`` and variance ``Σ w² v_q / N²``, ``N = max(Σ w, ε)``.

Out-of-image taps are dropped (zero weight).

``weight_math="fast"`` is the plain version of the TPU kernel's fast tap
weight (``ops/pallas/atrous_tpu.py`` ``_make_level_kernel(fast_weights=True)``),
which has no jnp oracle in the JAX package: the exponent moves to base 2,
the normal weight folds into it as ``−(c1·s + c2·s²)`` with
``s = |n_p − n_q|²`` (no ``max(n·n_q, 0)`` clamp), and one degree-3
polynomial ``2^y`` (``_exp2_fast3``) replaces exp and pow.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SVGFParams, WAVELET_SPLINE_5
from ..gbuffer import luminance
from .common import shift2d, valid_mask, finite_diff_gradients

_EPS = 1e-8
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# near-minimax degree-3 coefficients for exp(z) on [-ln2/2, ln2/2]; the
# values of ``_EXP3_C`` in the TPU kernel (max relative error 1.37e-4)
_EXP3_C = (0.999951338657045, 1.0001527445243588,
           0.5042261676140843, 0.16524081962961631)

WEIGHT_MATHS = ("exact", "fast")


def _spline_taps(radius: int) -> Tuple[float, ...]:
    """1-D kernel profile: B3 spline for r=2, binomial otherwise."""
    if radius == 2:
        return WAVELET_SPLINE_5
    if radius == 0:
        return (1.0,)
    n = 2 * radius
    taps = [math.comb(n, k) for k in range(n + 1)]
    s = float(sum(taps))
    return tuple(t / s for t in taps)


def variance_blur3x3(variance: torch.Tensor) -> torch.Tensor:
    """3x3 (¼,½,¼)² blur of the variance plane; border taps dropped and the
    weights renormalised."""
    H, W = variance.shape
    k1 = (0.25, 0.5, 0.25)
    num = torch.zeros_like(variance)
    den = torch.zeros_like(variance)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = k1[dy + 1] * k1[dx + 1]
            m = valid_mask(H, W, dy, dx, device=variance.device,
                           dtype=variance.dtype)
            num = num + k * m * shift2d(variance, dy, dx)
            den = den + k * m
    return num / den


def _exp2_fast3(y: torch.Tensor) -> torch.Tensor:
    """``2^y`` for y <= 0, ~1.4e-4 relative: round-to-nearest range reduction,
    the degree-3 polynomial on ``(y − round(y))·ln2``, and ``2^i`` assembled
    in the float's exponent field (``i`` floored at −126)."""
    yi = torch.floor(y + 0.5)
    z = (y - yi) * _LN2
    c0, c1, c2, c3 = _EXP3_C
    p = c0 + z * (c1 + z * (c2 + z * c3))
    # clamp before the int cast: |y| can exceed the int32 range
    i = torch.clamp(yi, min=-126.0).to(torch.int32)
    two_i = torch.bitwise_left_shift(i + 127, 23).view(torch.float32)
    return p * two_i


def atrous_level_ref(
    color: torch.Tensor,      # (3, H, W)
    variance: torch.Tensor,   # (H, W)
    normal: torch.Tensor,     # (3, H, W)
    depth: torch.Tensor,      # (H, W)
    zgrad: torch.Tensor = None,  # (2, H, W); computed if None
    *,
    level: int = 0,
    params: SVGFParams = SVGFParams(),
    weight_math: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One à-trous level.  Returns (filtered colour, filtered variance)."""
    if weight_math not in WEIGHT_MATHS:
        raise ValueError(f"unknown weight_math: {weight_math!r}")
    fast = weight_math == "fast"
    H, W = depth.shape
    spacing = 1 << level
    r = params.radius
    taps1d = _spline_taps(r)
    if zgrad is None:
        zgrad = finite_diff_gradients(depth)

    lum = luminance(color)
    sden = params.sigma_color * torch.sqrt(
        torch.clamp(variance_blur3x3(variance), min=0.0)) + _EPS
    if fast:
        # log2(e) folded into the reciprocal scales: the exponent is base 2
        isd2 = _LOG2E / torch.clamp(sden, min=_EPS)
        sz2 = params.sigma_depth * _LN2
        eps2 = _EPS * _LN2
        c_s1 = params.sigma_normal * _LOG2E * 0.5
        c_s2 = params.sigma_normal * _LOG2E * 0.125

    num_c = torch.zeros_like(color)
    num_v = torch.zeros_like(variance)
    den = torch.zeros_like(variance)

    luma_only = (params.luma_only_from is not None
                 and level >= params.luma_only_from)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing
            h = taps1d[dy + r] * taps1d[dx + r]
            m = valid_mask(H, W, oy, ox, device=depth.device,
                           dtype=depth.dtype)
            l_q = shift2d(lum, oy, ox)
            if not luma_only:
                z_q = shift2d(depth, oy, ox)
                n_q = shift2d(normal, oy, ox)
                zdot = torch.abs(zgrad[0] * oy + zgrad[1] * ox)
            if fast:
                arg = -torch.abs(lum - l_q) * isd2
                if not luma_only:
                    wz2 = -torch.abs(depth - z_q) / (sz2 * zdot + eps2)
                    d0 = normal[0] - n_q[0]
                    d1 = normal[1] - n_q[1]
                    d2 = normal[2] - n_q[2]
                    s = d0 * d0 + d1 * d1 + d2 * d2
                    arg = wz2 + arg - (c_s1 * s + c_s2 * (s * s))
                w = h * m * _exp2_fast3(arg)
            else:
                wl_exp = -torch.abs(lum - l_q) / sden
                if luma_only:
                    w = h * m * torch.exp(wl_exp)
                else:
                    wz_exp = -torch.abs(depth - z_q) / (
                        params.sigma_depth * zdot + _EPS)
                    ndot = torch.clamp(normal[0] * n_q[0] + normal[1] * n_q[1]
                                       + normal[2] * n_q[2], min=0.0)
                    wn = torch.pow(torch.clamp(ndot, min=1e-20),
                                   params.sigma_normal)
                    w = h * m * torch.exp(wz_exp + wl_exp) * wn

            num_c = num_c + w[None] * shift2d(color, oy, ox)
            num_v = num_v + (w * w) * shift2d(variance, oy, ox)
            den = den + w

    den = torch.clamp(den, min=_EPS)
    return num_c / den[None], num_v / (den * den)


def svgf_spatial_ref(
    color: torch.Tensor,
    variance: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    *,
    params: SVGFParams = SVGFParams(),
    return_feedback: bool = False,
    weight_math: str = "exact",
):
    """Full multi-level à-trous sweep.

    Returns the denoised colour and variance, and with ``return_feedback``
    also the colour after ``params.feedback_level`` levels, which SVGF feeds
    into the next frame's history instead of the fully filtered image.
    """
    if params.pyramid_from is not None:
        raise NotImplementedError("pyramid_from (half-resolution deep levels) "
                                  "is not ported")
    zgrad = finite_diff_gradients(depth)
    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        c, v = atrous_level_ref(c, v, normal, depth, zgrad, level=lvl,
                                params=params, weight_math=weight_math)
        if lvl + 1 == params.feedback_level:
            feedback = c
    if return_feedback:
        return c, v, feedback
    return c, v
