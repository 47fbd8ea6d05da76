"""Temporal reprojection, accumulation and variance estimation (SVGF): the
plain PyTorch version.

Counterpart of ``raymarchdenoisercuda_tpu/ops/temporal.py``; the CPU path and
the oracle of the CUDA kernels K3 (the fused inference step) and K4-K6 (the
differentiable reprojection and its adjoints, ``ops/cuda/temporal.cu``).
Per frame:

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

Tiles (``tile=Tile(origin, bounds)``, the sharded pipeline's kernel
forms K3b, K4c, K5c/K6c): the history comes as a canvas around the tile
(margin >= max_motion + 1) and the render as one with margin >= 3; every
tap, the reprojected position and the 3x3/7x7 windows are tested against
the frame in global coordinates, so a tile computes what the whole frame
computes at its pixels.

Unbounded motion (``max_motion=None``): the reprojection is the clamped
bilinear gather (:func:`bilinear_gather_clamped`), then the same
epilogue; on the card inference runs both in one kernel (K3's unbounded
step) and the differentiable step the gather's kernel and a hand-written
adjoint, then this epilogue.

Gradients: the bounded reprojection is a ``torch.autograd.Function``
(:func:`reproject_gather`) whose backward is written out with JAX's kink
conventions (``ops.common.tent_prime``), and the epilogue's maxima and
clamps use ``torch.maximum``/``torch.minimum``, which split a tie's
gradient 0.5/0.5 as ``jnp.maximum`` does; so autograd through
:func:`temporal_accumulate` gives ``jax.grad``'s gradients of the JAX
package's ``temporal_accumulate``.  :func:`temporal_step_bwd_ref` writes
the whole-frame step's render gradient out, with the same tie rule: the
plain twin of the CUDA adjoint K16 of the training step's fused route.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History, luminance
from ..utils.timing import count, span, spanned
from .common import (Tile, canvas_margin, crop, fma, shift2d,
                     tent, tent_prime, valid_mask)

# stack order of the reprojected history planes: colour 3, moments 2,
# length, previous depth, previous normal 3
N_HIST_PLANES = 10
# the epilogue's previous depth and normal (planes 6-9) feed boolean
# validity tests only: their cotangent is identically zero
GRAD_PLANES = 6


def bilinear_gather_clamped(stack: torch.Tensor,
                            motion: torch.Tensor) -> torch.Tensor:
    """Unbounded reprojection (``max_motion=None``, the reference's
    ``bilinear_gather_many``): bilinear sample of each plane of a (P, H, W)
    stack at ``p + motion`` with the taps clamped to the image.  The plain
    version of the clamped-gather kernel; autograd gives its adjoint."""
    P, H, W = stack.shape
    flat = stack.reshape(P, H * W)
    iy = torch.arange(H, device=stack.device)[:, None]
    ix = torch.arange(W, device=stack.device)[None, :]
    ys = iy.to(stack.dtype) + motion[0]
    xs = ix.to(stack.dtype) + motion[1]
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
    return fma(top, 1 - fy, bot * fy)


def _tap_geometry(motion: torch.Tensor, max_motion: int):
    """Per-pixel reprojection state shared by the gather and its adjoint:
    ``within`` (|m0|, |m1| <= M), the motion with rejected pixels zeroed
    (their tap indices stay bounded; their samples are 0), its floors, and
    the pixel coordinates."""
    H, W = motion.shape[-2:]
    m0, m1 = motion[0], motion[1]
    within = (torch.abs(m0) <= max_motion) & (torch.abs(m1) <= max_motion)
    m0w = torch.where(within, m0, torch.zeros_like(m0))
    m1w = torch.where(within, m1, torch.zeros_like(m1))
    iy = torch.arange(H, device=motion.device)[:, None]
    ix = torch.arange(W, device=motion.device)[None, :]
    return within, m0w, m1w, torch.floor(m0w), torch.floor(m1w), iy, ix


def _tap_index(iy, ix, dyf, dxf, H, W, ok, canvas=None):
    """Flat index of the tap at offset (dyf, dxf) and whether it is read:
    ``ok`` and inside the image.  ``canvas = (tile, margin, Hc, Wc)``: the
    tap is read when inside the frame, from the canvas around the tile."""
    ry = iy + dyf.to(torch.int64)
    rx = ix + dxf.to(torch.int64)
    if canvas is None:
        inside = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W) & ok
        idx = torch.clamp(ry, 0, H - 1) * W + torch.clamp(rx, 0, W - 1)
        return idx.reshape(-1), inside
    tile, m, Hc, Wc = canvas
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    gy, gx = ry + gy0, rx + gx0
    inside = (gy >= 0) & (gy < Hg) & (gx >= 0) & (gx < Wg) & ok
    idx = (torch.clamp(ry + m, 0, Hc - 1) * Wc
           + torch.clamp(rx + m, 0, Wc - 1))
    return idx.reshape(-1), inside


def _canvas_of(shape, motion, max_motion, tile):
    """``(tile, margin, Hc, Wc)`` of a history canvas of ``shape`` (…, Hc,
    Wc) around the tile of ``motion`` (None without a tile); the margin
    must hold every tap of an accepted motion (>= max_motion + 1)."""
    if tile is None:
        return None
    H, W = motion.shape[-2:]
    Hc, Wc = shape[-2:]
    m = (Hc - H) // 2
    if Hc != H + 2 * m or Wc != W + 2 * m or m < max_motion + 1:
        raise ValueError(f"history canvas {tuple(shape)}: not a {H}x{W} "
                         f"tile with a margin >= max_motion + 1 = "
                         f"{max_motion + 1} on every side")
    return tile, m, Hc, Wc


def gather_ref(stack: torch.Tensor, motion: torch.Tensor,
               max_motion: int, tile: Tile = None) -> torch.Tensor:
    """Plain version of K4: the bounded-motion tent gather of a (P, H, W)
    stack at ``p + motion``.  Pixels with ``|m0|`` or ``|m1| > max_motion``
    read zero, as do taps outside the image.  The four taps (y0, x0),
    (y0, x0+1), (y0+1, x0), (y0+1, x0+1) accumulate by fused multiply-adds
    with tent weights ``max(0, 1 − |m − d|)``: the order, weights and
    rounding of the reference's compiled sum.  With ``tile`` (K4c),
    ``stack`` is the history canvas around the tile of ``motion``; the
    result is the tile's."""
    P = stack.shape[0]
    H, W = motion.shape[-2:]
    canvas = _canvas_of(stack.shape, motion, max_motion, tile)
    within, m0w, m1w, y0, x0, iy, ix = _tap_geometry(motion, max_motion)
    flat = stack.reshape(P, -1)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    out = torch.zeros((P, H, W), dtype=stack.dtype, device=stack.device)
    for ay in (0, 1):
        dyf = y0 + ay
        ty = tent(m0w - dyf)
        for ax in (0, 1):
            dxf = x0 + ax
            tx = tent(m1w - dxf)
            idx, inside = _tap_index(iy, ix, dyf, dxf, H, W, within, canvas)
            val = torch.where(inside[None], flat[:, idx].reshape(P, H, W),
                              zero)
            out = fma((ty * tx)[None], val, out)
    return out


def gather_bwd_ref(stack, motion, g, max_motion: int, *, motion_grad: bool,
                   grad_planes: int = N_HIST_PLANES, tile: Tile = None,
                   canvas_shape=None):
    """Plain version of K5 (``motion_grad=True``) and K6 (False): the
    adjoint of :func:`gather_ref` for the cotangent ``g`` of its output.

    ``d_hist`` is the transposed tent scatter: each source pixel adds its
    tent-weighted cotangent into its (at most four) taps, for the leading
    ``grad_planes`` planes; the rest are exact zeros (valid when their
    cotangent is zero).  ``d_motion`` (zeros without ``motion_grad``) is,
    per pixel, ``Σ_c g_c Σ_d (tent'(m0−dy)·tent(m1−dx),
    tent(m0−dy)·tent'(m1−dx))·hist_c[p+d]`` over the offsets floor(m)−1 ..
    floor(m)+1 that lie in [−M, M+1]: at integer motion tent' is nonzero
    on all three (±0.5, −1, ±0.5, JAX's kink convention), which is why the
    JAX package's adjoint keeps floor+1 upper bounds.  ``stack`` may be
    None without ``motion_grad``.  With ``tile`` (K5c/K6c), ``d_hist`` is
    the gradient of the whole history canvas, margins included, of shape
    ``canvas_shape`` (P, Hc, Wc) (``stack``'s when given).  Returns
    ``(d_hist, d_motion)``."""
    P, H, W = g.shape
    NP = min(grad_planes, P)
    Hc, Wc = (H, W) if tile is None else tuple(
        (stack.shape if stack is not None else canvas_shape)[-2:])
    canvas = _canvas_of((Hc, Wc), motion, max_motion, tile)
    within, m0w, m1w, y0, x0, iy, ix = _tap_geometry(motion, max_motion)
    gw = g[:NP]
    dh = torch.zeros((P, Hc * Wc), dtype=g.dtype, device=g.device)
    for ay in (0, 1):
        dyf = y0 + ay
        ty = tent(m0w - dyf)
        for ax in (0, 1):
            dxf = x0 + ax
            tx = tent(m1w - dxf)
            idx, inside = _tap_index(iy, ix, dyf, dxf, H, W, within, canvas)
            sel = inside.reshape(-1)
            contrib = ((ty * tx)[None] * gw).reshape(NP, H * W)
            dh[:NP].index_add_(1, idx[sel], contrib[:, sel])
    dh = dh.reshape(P, Hc, Wc)
    dm = torch.zeros((2, H, W), dtype=g.dtype, device=g.device)
    if not motion_grad:
        return dh, dm
    flat = stack[:NP].reshape(NP, Hc * Wc)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dm0 = dm1 = torch.zeros((H, W), dtype=g.dtype, device=g.device)
    for ay in (-1, 0, 1):
        dyf = y0 + ay
        ty, typ = tent(m0w - dyf), tent_prime(m0w - dyf)
        for ax in (-1, 0, 1):
            dxf = x0 + ax
            tx, txp = tent(m1w - dxf), tent_prime(m1w - dxf)
            in_range = ((dyf >= -max_motion) & (dyf <= max_motion + 1)
                        & (dxf >= -max_motion) & (dxf <= max_motion + 1))
            idx, inside = _tap_index(iy, ix, dyf, dxf, H, W,
                                     within & in_range, canvas)
            val = torch.where(inside[None], flat[:, idx].reshape(NP, H, W),
                              zero)
            gdot = torch.zeros((H, W), dtype=g.dtype, device=g.device)
            for c in range(NP):
                gdot = gdot + gw[c] * val[c]
            dm0 = dm0 + (typ * tx) * gdot
            dm1 = dm1 + (ty * txp) * gdot
    return dh, torch.stack([dm0, dm1])


class _ReprojectGather(torch.autograd.Function):
    """Bounded tent reprojection with a written-out adjoint; ``fwd`` and
    ``bwd`` are the plain versions or the CUDA wrappers (K4, K5/K6)."""

    @staticmethod
    def forward(ctx, stack, motion, max_motion, motion_grad, grad_planes,
                fwd, bwd, tile=None):
        ctx.save_for_backward(stack if motion_grad else None, motion)
        ctx.args = (max_motion, motion_grad, grad_planes, bwd, tile,
                    tuple(stack.shape))
        if tile is None:
            return fwd(stack, motion, max_motion)
        return fwd(stack, motion, max_motion, tile=tile)

    @staticmethod
    @spanned("rdt.temporal.bwd")
    def backward(ctx, g):
        stack, motion = ctx.saved_tensors
        max_motion, motion_grad, grad_planes, bwd, tile, shape = ctx.args
        kw = {} if tile is None else dict(tile=tile, canvas_shape=shape)
        dh, dm = bwd(stack, motion, g.contiguous(), max_motion,
                     motion_grad=motion_grad, grad_planes=grad_planes, **kw)
        return (dh, dm if motion_grad else None, None, None, None, None,
                None, None)


def reproject_gather(stack: torch.Tensor, motion: torch.Tensor,
                     max_motion: int, *, motion_grad: bool = True,
                     grad_planes: int = N_HIST_PLANES,
                     tile: Tile = None) -> torch.Tensor:
    """Differentiable bounded reprojection of a (P, H, W) stack (the JAX
    package's ``_reproject_gather``): forward :func:`gather_ref`, backward
    :func:`gather_bwd_ref`.  ``motion_grad=False`` returns no motion
    gradient (exact when the loss does not reach motion, as in
    material-only training); ``grad_planes`` as in :func:`gather_bwd_ref`.
    With ``tile``, ``stack`` is the history canvas around the tile
    (``_reproject_gather_canvas``); its gradient covers the canvas."""
    return _ReprojectGather.apply(stack, motion, max_motion, motion_grad,
                                  grad_planes, gather_ref, gather_bwd_ref,
                                  tile)


def _neighborhood_minmax(color: torch.Tensor, radius: int = 1):
    """Per-pixel min/max of ``color`` over a (2r+1)^2 window; out-of-image
    taps dropped (separable: rows, then columns)."""
    H, W = color.shape[-2], color.shape[-1]
    inf = torch.full((), float("inf"), dtype=color.dtype, device=color.device)

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


def _neighborhood_minmax_tile(color_c: torch.Tensor, tile: Tile, H: int,
                              W: int, radius: int = 1):
    """:func:`_neighborhood_minmax` of an H x W tile from its colour canvas
    (margin >= radius), taps outside the frame dropped; rows, then
    columns, in the same order."""
    m = canvas_margin(color_c, H, W, "render canvas")
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    dev = color_c.device
    inf = torch.tensor(float("inf"), dtype=color_c.dtype, device=dev)
    rows = color_c[..., m:m + H, :]
    lo = hi = rows
    gy = torch.arange(gy0, gy0 + H, device=dev)[:, None]
    for d in range(-radius, radius + 1):
        if d == 0:
            continue
        ok = (gy + d >= 0) & (gy + d < Hg)
        s = color_c[..., m + d:m + d + H, :]
        lo = torch.minimum(lo, torch.where(ok, s, inf))
        hi = torch.maximum(hi, torch.where(ok, s, -inf))
    olo, ohi = lo[..., m:m + W], hi[..., m:m + W]
    gx = torch.arange(gx0, gx0 + W, device=dev)[None, :]
    for d in range(-radius, radius + 1):
        if d == 0:
            continue
        ok = (gx + d >= 0) & (gx + d < Wg)
        olo = torch.minimum(olo, torch.where(ok, lo[..., m + d:m + d + W],
                                             inf))
        ohi = torch.maximum(ohi, torch.where(ok, hi[..., m + d:m + d + W],
                                             -inf))
    return olo, ohi


def _spatial_moments_tile(lum_c: torch.Tensor, tile: Tile, H: int, W: int,
                          radius: int = 3):
    """:func:`spatial_moments` of an H x W tile from its luminance canvas
    (margin >= radius): taps outside the frame read zero and the count is
    the frame's; the sums run in the same order."""
    m = canvas_margin(lum_c, H, W, "luminance canvas")
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    Hc, Wc = lum_c.shape
    dev, dt = lum_c.device, lum_c.dtype
    cy = torch.arange(gy0 - m, gy0 - m + Hc, device=dev)[:, None]
    cx = torch.arange(gx0 - m, gx0 - m + Wc, device=dev)[None, :]
    inside = (cy >= 0) & (cy < Hg) & (cx >= 0) & (cx < Wg)
    lum_c = torch.where(inside, lum_c, torch.zeros((), dtype=dt, device=dev))

    def winsum(x):
        rows = x[m:m + H]
        for d in range(1, radius + 1):
            rows = rows + x[m + d:m + d + H] + x[m - d:m - d + H]
        out = rows[:, m:m + W]
        for d in range(1, radius + 1):
            out = out + rows[:, m + d:m + d + W] + rows[:, m - d:m - d + W]
        return out

    iy = torch.arange(gy0, gy0 + H, dtype=dt, device=dev)[:, None]
    ix = torch.arange(gx0, gx0 + W, dtype=dt, device=dev)[None, :]
    cnt_y = (torch.clamp(iy, max=float(radius))
             + torch.clamp(Hg - 1 - iy, max=float(radius)) + 1.0)
    cnt_x = (torch.clamp(ix, max=float(radius))
             + torch.clamp(Wg - 1 - ix, max=float(radius)) + 1.0)
    inv_cnt = 1.0 / (cnt_y * cnt_x)
    return winsum(lum_c) * inv_cnt, winsum(lum_c * lum_c) * inv_cnt


def _winsum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The (2r+1)^2 window sum of an (H, W) plane, zero outside the image:
    rows first (offsets 0, +1, −1, +2, −2, …), then columns in the same
    order.  Symmetric, so it is its own adjoint."""
    rows = x
    for d in range(1, radius + 1):
        rows = rows + shift2d(x, d, 0) + shift2d(x, -d, 0)
    out = rows
    for d in range(1, radius + 1):
        out = out + shift2d(rows, 0, d) + shift2d(rows, 0, -d)
    return out


def _inv_count(like: torch.Tensor, radius: int) -> torch.Tensor:
    """1 / the number of in-image taps of each pixel's (2r+1)^2 window."""
    H, W = like.shape[-2:]
    iy = torch.arange(H, dtype=like.dtype, device=like.device)[:, None]
    ix = torch.arange(W, dtype=like.dtype, device=like.device)[None, :]
    cy = (torch.clamp(iy, max=float(radius))
          + torch.clamp(H - 1 - iy, max=float(radius)) + 1.0)
    cx = (torch.clamp(ix, max=float(radius))
          + torch.clamp(W - 1 - ix, max=float(radius)) + 1.0)
    return 1.0 / (cy * cx)


def spatial_moments(lum: torch.Tensor, radius: int = 3):
    """Spatial (E[l], E[l^2]) over a (2r+1)^2 window, normalised by the
    number of in-image taps (:func:`_winsum`'s order)."""
    inv_cnt = _inv_count(lum, radius)
    return (_winsum(lum, radius) * inv_cnt,
            _winsum(lum * lum, radius) * inv_cnt)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``x`` beside ``like``, filled on the device:
    ``torch.tensor`` of a Python number would copy it from the host, a
    synchronising call on the card."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _validity(gbuf: GBuffer, prev_len, prev_depth, prev_normal, in_bounds):
    """The pixels whose reprojected history is taken: in bounds, depth
    within 10 %, ``n·n_prev > 0.8`` and a non-empty history."""
    depth_ok = torch.abs(prev_depth - gbuf.depth) <= 0.1 * torch.clamp(
        torch.abs(gbuf.depth), min=1e-3)
    n = gbuf.normal
    ndot = (prev_normal[0] * n[0] + prev_normal[1] * n[1]
            + prev_normal[2] * n[2])
    return in_bounds & depth_ok & (ndot > 0.8) & (prev_len > 0)


def _temporal_epilogue(gbuf: GBuffer, gathered, in_bounds, params: SVGFParams,
                       tile: Tile = None):
    """Validity, history clamp, EMA accumulation, moments and variance.
    With ``tile``, ``gbuf.render`` is the render canvas around the tile of
    ``gbuf.depth`` (margin >= 3); the rest is the tile's."""
    color = render_c = gbuf.render
    if tile is not None:
        H, W = gbuf.depth.shape
        color = crop(render_c, canvas_margin(render_c, H, W, "render"), 0,
                     0, H, W)
    prev_color, prev_moments, prev_len, prev_depth, prev_normal = gathered
    valid = _validity(gbuf, prev_len, prev_depth, prev_normal, in_bounds)

    if params.history_clamp:
        cmin, cmax = (_neighborhood_minmax(color, radius=1) if tile is None
                      else _neighborhood_minmax_tile(render_c, tile, H, W))
        prev_color = torch.minimum(torch.maximum(prev_color, cmin), cmax)

    n_prev = torch.where(valid, prev_len, torch.zeros_like(prev_len))
    n_new = n_prev + 1.0
    alpha = torch.maximum(_scalar(params.temporal_alpha, n_new), 1.0 / n_new)
    alpha_m = torch.maximum(_scalar(params.temporal_moments_alpha, n_new),
                            1.0 / n_new)

    integrated = torch.where(
        valid[None], (1 - alpha)[None] * prev_color + alpha[None] * color,
        color)

    lum = luminance(color)
    cur_moments = torch.stack([lum, lum * lum])
    moments = torch.where(
        valid[None],
        (1 - alpha_m)[None] * prev_moments + alpha_m[None] * cur_moments,
        cur_moments)

    zero = _scalar(0.0, lum)
    variance = torch.maximum(moments[1] - moments[0] * moments[0], zero)
    if params.variance_boost_frames > 0:
        sm1, sm2 = (spatial_moments(lum) if tile is None else
                    _spatial_moments_tile(luminance(render_c), tile, H, W))
        var_spatial = torch.maximum(sm2 - sm1 * sm1, zero)
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
    tile: Tile = None,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """One temporal step, differentiable by autograd.

    Returns ``(integrated_color, variance, new_history)``; the caller
    replaces ``new_history.color`` with the à-trous feedback level's output
    (``models/svgf.py``).

    ``tile`` given (K3's tile form and K3b's plain version): the history
    planes are canvases around the tile of ``gbuf.depth`` (margin >=
    max_motion + 1; one (10, Hc, Wc) canvas is split by
    :func:`history_from_stack`), ``gbuf.render`` a canvas with margin >= 3,
    and motion, depth and normal the tile's; bounded motion only.
    """
    if tile is not None:
        return temporal_step_ad(gbuf, history, params, reproject_gather,
                                motion_grad=True, grad_planes=N_HIST_PLANES,
                                tile=tile)
    if params.max_motion is None:
        return temporal_step_clamped(gbuf, history, params,
                                     bilinear_gather_clamped)
    return temporal_step_ad(gbuf, history, params, reproject_gather,
                            motion_grad=True, grad_planes=N_HIST_PLANES)


def _motion(gbuf: GBuffer) -> torch.Tensor:
    H, W = gbuf.depth.shape
    return (gbuf.motion if gbuf.motion is not None
            else torch.zeros((2, H, W), dtype=gbuf.render.dtype,
                             device=gbuf.render.device))


def _in_bounds(motion: torch.Tensor, max_motion,
               tile: Tile = None) -> torch.Tensor:
    """Pixels whose reprojection lands inside the image and, with a bound,
    whose |m0| and |m1| are within it (with ``tile``: inside the frame, in
    global coordinates)."""
    H, W = motion.shape[-2:]
    (gy0, gx0), (Hg, Wg) = ((0, 0), (H, W)) if tile is None else (
        tile.origin, tile.bounds)
    iy = torch.arange(gy0, gy0 + H, dtype=motion.dtype,
                      device=motion.device)[:, None]
    ix = torch.arange(gx0, gx0 + W, dtype=motion.dtype,
                      device=motion.device)[None, :]
    ys, xs = iy + motion[0], ix + motion[1]
    ok = (ys >= 0) & (ys <= Hg - 1) & (xs >= 0) & (xs <= Wg - 1)
    if max_motion is None:
        return ok
    return (ok & (torch.abs(motion[0]) <= max_motion)
            & (torch.abs(motion[1]) <= max_motion))


def history_stack(history: History) -> torch.Tensor:
    """The (10, H, W) stack of the history planes, in the reprojection's
    order."""
    return torch.cat([history.color, history.moments, history.length[None],
                      history.prev_depth[None], history.prev_normal])


def history_stack_channel_minor(history: History) -> torch.Tensor:
    """:func:`history_stack`'s (10, H, W) stack laid out channel-minor,
    strides (1, 10·W, 10): a texel's 10 planes contiguous, as the clamped
    gather reads them on the card (the JAX package's ``bilinear_gather_many``
    stacks its planes (H·W, 10) for the same reason).  One copy, as
    :func:`history_stack`'s ``cat`` is; differentiable."""
    planes = (*history.color.unbind(0), *history.moments.unbind(0),
              history.length, history.prev_depth,
              *history.prev_normal.unbind(0))
    return torch.stack(planes, dim=-1).permute(2, 0, 1)


def history_from_stack(stack: torch.Tensor) -> History:
    """The History whose planes are views of a (10, H, W) stack."""
    return History(color=stack[0:3], moments=stack[3:5], length=stack[5],
                   prev_depth=stack[6], prev_normal=stack[7:10])


def temporal_step_clamped(gbuf: GBuffer, history: History,
                          params: SVGFParams, gather, stack=history_stack):
    """The temporal step with unbounded motion (``max_motion=None``, the JAX
    package's jnp ``temporal_accumulate``): the clamped bilinear gather of
    the history stack, ``stack(history)`` (:func:`history_stack`, or on the
    card :func:`history_stack_channel_minor`), by ``gather(stack, motion)``
    (:func:`bilinear_gather_clamped` or its CUDA counterpart), then the
    shared epilogue; differentiable when ``gather`` is.

    While spans record: the spans ``rdt.temporal.gather`` (the stack and
    the gather: KGp and KG on the card's differentiable route) and
    ``rdt.temporal.epilogue``, and one on the host counter
    ``temporal_unbounded``."""
    count("temporal_unbounded", 1)
    motion = _motion(gbuf)
    with span("rdt.temporal.gather"):
        g = gather(stack(history), motion)
    planes = (g[0:3], g[3:5], g[5], g[6], g[7:10])
    with span("rdt.temporal.epilogue"):
        return _temporal_epilogue(gbuf, planes, _in_bounds(motion, None),
                                  params)


def temporal_step_ad(gbuf: GBuffer, history, params: SVGFParams,
                     gather, *, motion_grad: bool, grad_planes: int,
                     tile: Tile = None):
    """The differentiable temporal step with bounded motion (the JAX
    package's ``temporal_accumulate_pallas_ad``): stack the history planes,
    reproject them with ``gather`` (:func:`reproject_gather` or its CUDA
    counterpart), and run the shared epilogue.  ``history`` may be the
    (10, …) stack itself; with ``tile``, a canvas (see
    :func:`temporal_accumulate`)."""
    if params.max_motion is None:
        raise ValueError("the differentiable temporal step requires "
                         "SVGFParams.max_motion (bounded reprojection)")
    motion = _motion(gbuf)
    stack = (history if isinstance(history, torch.Tensor)
             else history_stack(history))
    kw = {} if tile is None else dict(tile=tile)
    gathered = gather(stack, motion, params.max_motion,
                      motion_grad=motion_grad, grad_planes=grad_planes, **kw)
    planes = (gathered[0:3], gathered[3:5], gathered[5], gathered[6],
              gathered[7:10])
    return _temporal_epilogue(gbuf, planes,
                              _in_bounds(motion, params.max_motion, tile),
                              params, tile)


def temporal_accumulate_ad(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    motion_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """The differentiable temporal step of training (plain version of the
    K4-K6 path): the values of :func:`temporal_accumulate`, with the
    adjoint limited to the ``GRAD_PLANES`` history planes that have a
    gradient, and without the motion gradient if ``motion_grad`` is False.
    With ``max_motion=None`` it is :func:`temporal_accumulate`'s clamped
    step under autograd (the JAX package differentiates its jnp step
    there), whose motion gradient flows wherever motion requires grad.
    Returns ``(integrated, variance, new_history)``."""
    if params.max_motion is None:
        return temporal_step_clamped(gbuf, history, params,
                                     bilinear_gather_clamped)
    return temporal_step_ad(gbuf, history, params, reproject_gather,
                            motion_grad=motion_grad, grad_planes=GRAD_PLANES)


# ---------------------------------------------------------------------------
# the written-out adjoint of the step with respect to the render
# ---------------------------------------------------------------------------

def _tie_weight(strict: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """1 where ``strict``, 0.5 where ``tie``, else 0: the share of a
    cotangent that autograd's ``torch.minimum``/``torch.maximum`` pass to
    one side (a tie splits it in halves)."""
    return torch.where(strict, 1.0, torch.where(tie, 0.5, 0.0))


def _stage_taps(v: torch.Tensor, axis_is_y: bool, lower: bool):
    """The taps p − e and p + e of one pass of :func:`_neighborhood_minmax`
    (radius 1), +inf (min) or −inf (max) outside the image."""
    H, W = v.shape[-2:]
    fill = float("inf") if lower else float("-inf")
    dy, dx = (1, 0) if axis_is_y else (0, 1)
    before = valid_mask(H, W, -dy, -dx, device=v.device) > 0
    after = valid_mask(H, W, dy, dx, device=v.device) > 0
    return (torch.where(before, shift2d(v, -dy, -dx), fill),
            torch.where(after, shift2d(v, dy, dx), fill))


def _chain_shares(a, b, c, lower: bool):
    """The shares of the cotangent of ``m(m(a, b), c)`` (m = min when
    ``lower``, else max) that reach a, b and c, autograd's tie rule at each
    link."""
    first = torch.lt if lower else torch.gt
    o1 = torch.minimum(a, b) if lower else torch.maximum(a, b)
    wc = _tie_weight(first(c, o1), c == o1)
    wo = _tie_weight(first(o1, c), o1 == c)
    return (wo * _tie_weight(first(a, b), a == b),
            wo * _tie_weight(first(b, a), a == b), wc)


def _minmax_stage(v: torch.Tensor, axis_is_y: bool, lower: bool):
    """One pass of :func:`_neighborhood_minmax` (radius 1), min or max."""
    b, c = _stage_taps(v, axis_is_y, lower)
    m = torch.minimum if lower else torch.maximum
    return m(m(v, b), c)


def _minmax_stage_bwd(v, d, axis_is_y: bool, lower: bool):
    """The adjoint of :func:`_minmax_stage` of ``v`` for the cotangent
    ``d`` of its output, in gather form: each pixel takes its own share,
    then the −e share of p + e, then the +e share of p − e."""
    dy, dx = (1, 0) if axis_is_y else (0, 1)
    wa, wb, wc = _chain_shares(v, *_stage_taps(v, axis_is_y, lower), lower)
    return (d * wa + shift2d(d * wb, dy, dx)) + shift2d(d * wc, -dy, -dx)


def _clamp_bwd(color, prev, gp):
    """The render's cotangent through the history clamp
    ``min(max(prev, cmin), cmax)`` for the cotangent ``gp`` of the clamped
    colour: ``cmin``/``cmax``'s shares, then the separable chain back to
    the render (columns' pass, then rows')."""
    rlo = _minmax_stage(color, True, True)
    rhi = _minmax_stage(color, True, False)
    cmin = _minmax_stage(rlo, False, True)
    cmax = _minmax_stage(rhi, False, False)
    u = torch.maximum(prev, cmin)
    d_cmax = gp * _tie_weight(cmax < u, cmax == u)
    d_cmin = gp * (_tie_weight(u < cmax, u == cmax)
                   * _tie_weight(cmin > prev, cmin == prev))
    lo = _minmax_stage_bwd(color, _minmax_stage_bwd(rlo, d_cmin, False, True),
                           True, True)
    hi = _minmax_stage_bwd(color, _minmax_stage_bwd(rhi, d_cmax, False,
                                                    False), True, False)
    return lo + hi


def temporal_step_bwd_ref(gbuf: GBuffer, history: History,
                          moments: torch.Tensor, n_new: torch.Tensor,
                          g_integrated, g_variance, g_moments,
                          params: SVGFParams) -> torch.Tensor:
    """The render's cotangent of the bounded whole-frame temporal step
    (:func:`temporal_accumulate`) whose outputs' cotangents are
    ``g_integrated`` (3, H, W), ``g_variance`` (H, W) and ``g_moments``
    (2, H, W) (each may be None: zero), from the step's inputs and its
    outputs ``moments`` and ``n_new`` (the new history's moments and
    length).  The derivative autograd takes of the plain epilogue, every
    term, written out (the plain twin of the CUDA adjoint of
    ``temporal_cuda.temporal_accumulate_ad_cuda``'s fused route, which
    follows it operation by operation):

    * its own blend, ``alpha`` where the history is valid, else 1;
    * the history clamp ``min(max(prev, cmin), cmax)``: the clamped
      colour's cotangent ``(1 − alpha)·g`` to ``cmin``/``cmax``, then back
      through the separable 3x3 min/max (rows, then columns, offsets −1
      then +1), a tie splitting its cotangent in halves at each link, as
      ``torch.minimum``/``torch.maximum`` do;
    * the moments and the variance ``max(m2 − m1², 0)`` through the
      luminance (a tie at 0 halves too);
    * while ``n_new < variance_boost_frames``, the spatial variance: its
      cotangent over the 7x7 window sums, which are their own adjoint.

    History, motion, depth and normal take no gradient here (the fused
    route runs only where none is asked for)."""
    color = gbuf.render
    motion = _motion(gbuf)
    zeros = torch.zeros_like
    g_i = zeros(color) if g_integrated is None else g_integrated
    g_v = zeros(n_new) if g_variance is None else g_variance
    g_m = zeros(moments) if g_moments is None else g_moments
    g = gather_ref(history_stack(history), motion, params.max_motion)
    valid = _validity(gbuf, g[5], g[6], g[7:10],
                      _in_bounds(motion, params.max_motion))
    alpha = torch.clamp(1.0 / n_new, min=params.temporal_alpha)
    alpha_m = torch.clamp(1.0 / n_new, min=params.temporal_moments_alpha)

    own = g_i * torch.where(valid, alpha, 1.0)
    if params.history_clamp:
        gp = torch.where(valid, g_i * (1 - alpha), 0.0)
        clamp = _clamp_bwd(color, g[0:3], gp)
    else:
        clamp = zeros(color)

    lum = luminance(color)
    short = (n_new < params.variance_boost_frames
             if params.variance_boost_frames > 0
             else torch.zeros_like(n_new, dtype=torch.bool))
    m0, m1 = moments[0], moments[1]
    t = m1 - m0 * m0
    dv = torch.where(short, 0.0, g_v * _tie_weight(t > 0, t == 0))
    d_m1 = g_m[1] + dv
    sq = dv * m0
    d_m0 = g_m[0] - (sq + sq)
    am = torch.where(valid, alpha_m, 1.0)
    t1 = (d_m1 * am) * lum
    dlum = (d_m0 * am) + (t1 + t1)
    if params.variance_boost_frames > 0:
        inv = _inv_count(lum, 3)
        sm1, sm2 = spatial_moments(lum)
        ts = sm2 - sm1 * sm1
        dvs = torch.where(short, g_v * _tie_weight(ts > 0, ts == 0), 0.0)
        q = dvs * sm1
        t2 = _winsum(dvs * inv, 3) * lum
        dlum_s = _winsum((-(q + q)) * inv, 3) + (t2 + t2)
    else:
        dlum_s = zeros(lum)
    dlum = dlum + dlum_s
    return (own + clamp) + torch.stack(
        [0.2126 * dlum, 0.7152 * dlum, 0.0722 * dlum])
