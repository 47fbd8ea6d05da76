"""Temporal reprojection, accumulation and variance estimation (SVGF): the
plain PyTorch version.

Counterpart of ``raymarchdenoisercuda_tpu/ops/temporal.py``; the CPU path and
the oracle of the CUDA kernel K3 (``ops/cuda/temporal.cu``).  Per frame:

1. reproject: bilinearly sample the history at ``p + motion``; with a bound
   ``max_motion`` a pixel whose ``|m0|`` or ``|m1|`` exceeds it counts as
   disoccluded, and taps outside the image read zero;
2. validate: in bounds, relative depth within 10 %, normals within
   ``n·n_prev > 0.8``, non-empty history;
3. accumulate: clamp the history colour to the 3x3 min/max of the current
   frame, then blend with ``alpha = max(alpha_min, 1/n)``;
4. moments/variance: blend (E[l], E[l^2]); while the history is shorter than
   ``variance_boost_frames`` use a 7x7 spatial estimate instead.

Motion convention: ``motion[:, p] = (dy, dx)`` points from p to the matching
pixel of the previous frame.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History, luminance
from .common import fma, shift2d, valid_mask


def _stack_planes(planes) -> Tuple[torch.Tensor, List[int]]:
    H, W = planes[0].shape[-2:]
    chans, splits = [], []
    for p in planes:
        lead = p.shape[0] if p.dim() > 2 else 1
        chans.append(p.reshape(lead, H, W))
        splits.append(lead)
    return torch.cat(chans, 0), splits


def _unstack_planes(out: torch.Tensor, planes, splits):
    results, o = [], 0
    for p, lead in zip(planes, splits):
        results.append(out[o:o + lead].reshape(p.shape))
        o += lead
    return results


def bilinear_reproject(planes, motion: torch.Tensor, max_motion):
    """Bilinear sample of each (…, H, W) plane at ``p + motion``.

    With ``max_motion`` set: taps outside the image read zero, and pixels
    with ``|m0| > max_motion`` or ``|m1| > max_motion`` are flagged in the
    returned ``within`` mask (their samples are zero).  The four taps
    accumulate by fused multiply-adds in the order (y0, x0), (y0, x0+1),
    (y0+1, x0), (y0+1, x0+1) with tent weights ``max(0, 1 − |m − d|)``,
    the order, weights and rounding of the reference's compiled
    streaming-shift sum.  With ``max_motion=None`` the taps
    clamp to the image instead (the reference's unbounded gather) and every
    pixel is ``within``.  Returns ``(samples, within)``.
    """
    stack, splits = _stack_planes(planes)
    P, H, W = stack.shape
    m0, m1 = motion[0], motion[1]
    dev = stack.device
    iy = torch.arange(H, device=dev)[:, None]
    ix = torch.arange(W, device=dev)[None, :]
    flat = stack.reshape(P, H * W)

    if max_motion is None:
        ys = iy.to(stack.dtype) + m0
        xs = ix.to(stack.dtype) + m1
        y0 = torch.floor(ys)
        x0 = torch.floor(xs)
        fy, fx = ys - y0, xs - x0
        y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
        x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
        y1i = torch.clamp(y0i + 1, 0, H - 1)
        x1i = torch.clamp(x0i + 1, 0, W - 1)

        def at(yi, xi):
            return flat[:, (yi * W + xi).reshape(-1)].reshape(P, H, W)

        # a·b + c·d rounds as the reference's compiled fma(a, b, c·d)
        top = fma(at(y0i, x0i), 1 - fx, at(y0i, x1i) * fx)
        bot = fma(at(y1i, x0i), 1 - fx, at(y1i, x1i) * fx)
        out = fma(top, 1 - fy, bot * fy)
        within = torch.ones((H, W), dtype=torch.bool, device=dev)
        return _unstack_planes(out, planes, splits), within

    within = (torch.abs(m0) <= max_motion) & (torch.abs(m1) <= max_motion)
    # keep the tap indices of rejected pixels bounded; their samples are 0
    m0w = torch.where(within, m0, torch.zeros_like(m0))
    m1w = torch.where(within, m1, torch.zeros_like(m1))
    y0 = torch.floor(m0w)
    x0 = torch.floor(m1w)
    out = torch.zeros_like(stack)
    for ay in (0, 1):
        dyf = y0 + ay
        ty = torch.clamp(1.0 - torch.abs(m0w - dyf), min=0.0)
        ry = iy + dyf.to(torch.int64)
        for ax in (0, 1):
            dxf = x0 + ax
            tx = torch.clamp(1.0 - torch.abs(m1w - dxf), min=0.0)
            rx = ix + dxf.to(torch.int64)
            inside = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W) & within
            idx = (torch.clamp(ry, 0, H - 1) * W
                   + torch.clamp(rx, 0, W - 1)).reshape(-1)
            val = torch.where(inside[None], flat[:, idx].reshape(P, H, W),
                              torch.zeros((), dtype=stack.dtype, device=dev))
            out = fma((ty * tx)[None], val, out)
    return _unstack_planes(out, planes, splits), within


def _neighborhood_minmax(color: torch.Tensor, radius: int = 1):
    """Per-pixel min/max of ``color`` over a (2r+1)^2 window; out-of-image
    taps dropped (separable: rows, then columns)."""
    H, W = color.shape[-2], color.shape[-1]
    inf = torch.tensor(float("inf"), dtype=color.dtype, device=color.device)

    def one_axis(lo, hi, axis_is_y):
        olo, ohi = lo, hi
        for d in range(-radius, radius + 1):
            if d == 0:
                continue
            dy, dx = (d, 0) if axis_is_y else (0, d)
            m = valid_mask(H, W, dy, dx, device=color.device) > 0
            olo = torch.minimum(olo, torch.where(m, shift2d(lo, dy, dx), inf))
            ohi = torch.maximum(ohi, torch.where(m, shift2d(hi, dy, dx), -inf))
        return olo, ohi

    cmin, cmax = one_axis(color, color, True)
    return one_axis(cmin, cmax, False)


def spatial_moments(lum: torch.Tensor, radius: int = 3):
    """Spatial (E[l], E[l^2]) over a (2r+1)^2 window, normalised by the
    number of in-image taps.  Sums run rows first (offsets 0, +1, −1, +2,
    −2, …), then columns in the same order."""
    H, W = lum.shape

    def winsum(x):
        rows = x
        for d in range(1, radius + 1):
            rows = rows + shift2d(x, d, 0) + shift2d(x, -d, 0)
        out = rows
        for d in range(1, radius + 1):
            out = out + shift2d(rows, 0, d) + shift2d(rows, 0, -d)
        return out

    iy = torch.arange(H, dtype=lum.dtype, device=lum.device)[:, None]
    ix = torch.arange(W, dtype=lum.dtype, device=lum.device)[None, :]
    cy = (torch.clamp(iy, max=float(radius))
          + torch.clamp(H - 1 - iy, max=float(radius)) + 1.0)
    cx = (torch.clamp(ix, max=float(radius))
          + torch.clamp(W - 1 - ix, max=float(radius)) + 1.0)
    inv_cnt = 1.0 / (cy * cx)
    return winsum(lum) * inv_cnt, winsum(lum * lum) * inv_cnt


def _temporal_epilogue(gbuf: GBuffer, gathered, in_bounds, params: SVGFParams):
    """Validity, history clamp, EMA accumulation, moments and variance."""
    color = gbuf.render
    prev_color, prev_moments, prev_len, prev_depth, prev_normal = gathered

    depth_ok = torch.abs(prev_depth - gbuf.depth) <= 0.1 * torch.clamp(
        torch.abs(gbuf.depth), min=1e-3)
    n = gbuf.normal
    ndot = (prev_normal[0] * n[0] + prev_normal[1] * n[1]
            + prev_normal[2] * n[2])
    valid = in_bounds & depth_ok & (ndot > 0.8) & (prev_len > 0)

    if params.history_clamp:
        cmin, cmax = _neighborhood_minmax(color, radius=1)
        prev_color = torch.minimum(torch.maximum(prev_color, cmin), cmax)

    n_prev = torch.where(valid, prev_len, torch.zeros_like(prev_len))
    n_new = n_prev + 1.0
    alpha = torch.clamp(1.0 / n_new, min=params.temporal_alpha)
    alpha_m = torch.clamp(1.0 / n_new, min=params.temporal_moments_alpha)

    integrated = torch.where(
        valid[None], (1 - alpha)[None] * prev_color + alpha[None] * color,
        color)

    lum = luminance(color)
    cur_moments = torch.stack([lum, lum * lum])
    moments = torch.where(
        valid[None],
        (1 - alpha_m)[None] * prev_moments + alpha_m[None] * cur_moments,
        cur_moments)

    variance = torch.clamp(moments[1] - moments[0] * moments[0], min=0.0)
    if params.variance_boost_frames > 0:
        sm1, sm2 = spatial_moments(lum)
        var_spatial = torch.clamp(sm2 - sm1 * sm1, min=0.0)
        variance = torch.where(n_new < params.variance_boost_frames,
                               var_spatial, variance)

    new_history = History(color=integrated, moments=moments, length=n_new,
                          prev_depth=gbuf.depth, prev_normal=gbuf.normal)
    return integrated, variance, new_history


def temporal_accumulate(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """One temporal step.

    Returns ``(integrated_color, variance, new_history)``; the caller
    replaces ``new_history.color`` with the à-trous feedback level's output
    (``models/svgf.py``).
    """
    H, W = gbuf.shape
    color = gbuf.render
    motion = (gbuf.motion if gbuf.motion is not None
              else torch.zeros((2, H, W), dtype=color.dtype,
                               device=color.device))
    iy = torch.arange(H, dtype=color.dtype, device=color.device)[:, None]
    ix = torch.arange(W, dtype=color.dtype, device=color.device)[None, :]
    ys = iy + motion[0]
    xs = ix + motion[1]
    in_bounds = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)

    hist_planes = [history.color, history.moments, history.length,
                   history.prev_depth, history.prev_normal]
    gathered, within = bilinear_reproject(hist_planes, motion,
                                          params.max_motion)
    return _temporal_epilogue(gbuf, gathered, in_bounds & within, params)
