"""Edge-aware à-trous wavelet filter (SVGF spatial pass): the plain PyTorch
version.

Counterpart of ``raymarchdenoisercuda_tpu/ops/atrous.py``.  It is the CPU
path and the oracle that the CUDA kernels K1 (the level forward) and K2 (the
stored-weight adjoint, ``ops/cuda/atrous.cu``) are held against on the card;
it is never a fallback for a CUDA tensor.

Per level, at tap spacing ``s = 2^level``, for centre p and tap q = p + s·d:

* ``h(d) = taps[dy]·taps[dx]`` (B3 spline for radius 2, binomial otherwise);
* ``w = h · exp(−|z_p−z_q| / (σz·|∇z_p·(q−p)| + ε) − |l_p−l_q| / σden_p)
  · max(n_p·n_q, 0)^σn`` with ``σden = σl·sqrt(blur3x3(var)) + ε``;
* colour ``Σ w c_q / N`` and variance ``Σ w² v_q / N²``, ``N = max(Σ w, ε)``.

Out-of-image taps are dropped (zero weight).

Gradients: with ``detach_weights=True`` (the default, as in the JAX package)
the edge-stopping weights are constants for autograd, so a level is linear
in its colour and variance; ``detach_weights=False`` differentiates through
them.  The stored-weight adjoint (the kernel path's backward) is written out
in :func:`atrous_level_bwd_stored_ref`; its forward half is
``atrous_level_ref(..., return_weights=True)``, which also returns the tap
weights and the normaliser N.

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
    detach_weights: bool = True,
    return_weights: bool = False,
):
    """One à-trous level.  Returns (filtered colour, filtered variance), and
    with ``return_weights`` also the (n_taps, H, W) float32 tap weights
    (``h·mask`` included, so out-of-image taps are 0; tap k = (dy+r)(2r+1) +
    (dx+r)) and the normaliser ``N = max(Σ w, ε)``, which the stored-weight
    adjoint consumes."""
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
    var_w = variance
    if detach_weights:
        lum, var_w = lum.detach(), variance.detach()
    sden = params.sigma_color * torch.sqrt(
        torch.clamp(variance_blur3x3(var_w), min=0.0)) + _EPS
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
    weights = []
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
            if detach_weights:
                w = w.detach()
            if return_weights:
                weights.append(w)

            num_c = num_c + w[None] * shift2d(color, oy, ox)
            num_v = num_v + (w * w) * shift2d(variance, oy, ox)
            den = den + w

    den = torch.clamp(den, min=_EPS)
    if return_weights:
        return (num_c / den[None], num_v / (den * den), torch.stack(weights),
                den)
    return num_c / den[None], num_v / (den * den)


def atrous_level_bwd_stored_ref(
    w: torch.Tensor,    # (n_taps, H, W) stored tap weights (bf16 or f32)
    norm: torch.Tensor,  # (H, W) N of the forward
    gc: torch.Tensor,   # (3, H, W) cotangent of the filtered colour
    gv: torch.Tensor,   # (H, W) cotangent of the filtered variance
    *,
    level: int,
    radius: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: the detached adjoint of one level from the
    forward's stored weights.

    With ``u = gc/max(N, ε)`` and ``u2 = gv/max(N, ε)²`` at each centre p,
    ``dc_x = Σ_d w_{x−d}(d)·u_{x−d}`` and ``dv_x = Σ_d w_{x−d}(d)²·u2_{x−d}``
    (taps at spacing 2^level, summed in tap order, each weight widened to
    float32 first).  Returns ``(d_color, d_variance)``."""
    spacing = 1 << level
    r = radius
    inv_n = 1.0 / torch.clamp(norm, min=_EPS)
    u = gc * inv_n[None]
    u2 = gv * (inv_n * inv_n)
    acc_c = torch.zeros_like(gc)
    acc_v = torch.zeros_like(gv)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            k = (dy + r) * (2 * r + 1) + (dx + r)
            # centre p = x − d: read everything shifted by −d
            oy, ox = -dy * spacing, -dx * spacing
            w_sh = shift2d(w[k].float(), oy, ox)
            acc_c = acc_c + w_sh[None] * shift2d(u, oy, ox)
            acc_v = acc_v + (w_sh * w_sh) * shift2d(u2, oy, ox)
    return acc_c, acc_v


def svgf_spatial_ref(
    color: torch.Tensor,
    variance: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    *,
    params: SVGFParams = SVGFParams(),
    return_feedback: bool = False,
    weight_math: str = "exact",
    detach_weights: bool = True,
):
    """Full multi-level à-trous sweep, differentiable by autograd (through
    the weights too with ``detach_weights=False``).

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
                                params=params, weight_math=weight_math,
                                detach_weights=detach_weights)
        if lvl + 1 == params.feedback_level:
            feedback = c
    if return_feedback:
        return c, v, feedback
    return c, v
