"""Plain PyTorch reference of the SVGF denoiser with the paper's unbounded
reprojection (Schied et al., HPG 2017, section 4.1): the history is read
along the motion vectors wherever they land inside the image, however far
a pixel moved.

The demodulation, the history clamp's 3x3 min/max, the 7x7 spatial
moments, the à-trous sweep and the remodulation are the bounded
reference's (``denoise.py``, unchanged); this module writes the
reprojection and the temporal step that uses it.  It imports nothing of
the program.  Every function runs in the dtype of its inputs; ``params``
is the configuration's ``svgf`` dict, whose ``max_motion`` (null) it does
not read.

Departure from the paper, as in the port and the JAX package: the paper
tests the depth and normal of each of the four bilinear taps and, where
none passes, searches the 3x3 neighbourhood; here the history's depth and
normal are interpolated with its colour and tested once, at the
interpolated position.
"""

from __future__ import annotations

import torch

from .denoise import (demodulate, fma, luminance, neighbourhood_minmax,
                      remodulate, spatial_moments, sweep, zero_history)

__all__ = ["reproject_clamped", "temporal", "denoise", "zero_history"]


def reproject_clamped(stack, motion):
    """Bilinear gather of a (P, H, W) stack at p + motion, each of the four
    taps clamped to the image: the rows' blends by ``1 − fx`` and ``fx``,
    then the columns' by ``1 − fy`` and ``fy``, each a·b + c·d rounded as
    the fused multiply-add ``fma(a, b, c·d)``."""
    P, H, W = stack.shape
    iy = torch.arange(H, device=stack.device)[:, None]
    ix = torch.arange(W, device=stack.device)[None, :]
    ys = iy.to(stack.dtype) + motion[0]
    xs = ix.to(stack.dtype) + motion[1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    rows = [torch.clamp(y0i + a, 0, H - 1) for a in (0, 1)]
    cols = [torch.clamp(x0i + a, 0, W - 1) for a in (0, 1)]
    flat = stack.reshape(P, H * W)

    def tap(yi, xi):
        return flat[:, (yi * W + xi).reshape(-1)].reshape(P, H, W)

    top = fma(tap(rows[0], cols[0]), 1 - fx, tap(rows[0], cols[1]) * fx)
    bot = fma(tap(rows[1], cols[0]), 1 - fx, tap(rows[1], cols[1]) * fx)
    return fma(top, 1 - fy, bot * fy)


def temporal(g, hist, params, render):
    """One temporal step of the (demodulated) ``render`` with unbounded
    reprojection: returns ``(integrated, variance, new_history)``.  A pixel
    takes its history where p + motion lies inside the image, the depth is
    within 10 %, the normals agree (n·n_prev > 0.8) and the history is not
    empty."""
    H, W = g["depth"].shape
    motion = g["motion"]
    stack = torch.cat([hist["color"], hist["moments"], hist["length"][None],
                       hist["prev_depth"][None], hist["prev_normal"]])
    gathered = reproject_clamped(stack, motion)
    prev_color, prev_moments = gathered[0:3], gathered[3:5]
    prev_len, prev_depth, prev_normal = gathered[5], gathered[6], gathered[7:]
    iy = torch.arange(H, dtype=motion.dtype, device=motion.device)[:, None]
    ix = torch.arange(W, dtype=motion.dtype, device=motion.device)[None, :]
    ys, xs = iy + motion[0], ix + motion[1]
    in_image = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    depth, n = g["depth"], g["normal"]
    depth_ok = torch.abs(prev_depth - depth) <= 0.1 * torch.clamp(
        torch.abs(depth), min=1e-3)
    ndot = (prev_normal[0] * n[0] + prev_normal[1] * n[1]
            + prev_normal[2] * n[2])
    valid = in_image & depth_ok & (ndot > 0.8) & (prev_len > 0)
    color = render
    if params["history_clamp"]:
        cmin, cmax = neighbourhood_minmax(color)
        prev_color = torch.minimum(torch.maximum(prev_color, cmin), cmax)

    def scalar(x):
        return torch.tensor(x, dtype=color.dtype, device=color.device)

    n_prev = torch.where(valid, prev_len, torch.zeros_like(prev_len))
    n_new = n_prev + 1.0
    alpha = torch.maximum(scalar(params["temporal_alpha"]), 1.0 / n_new)
    alpha_m = torch.maximum(scalar(params["temporal_moments_alpha"]),
                            1.0 / n_new)
    integrated = torch.where(
        valid[None], (1 - alpha)[None] * prev_color + alpha[None] * color,
        color)
    lum = luminance(color)
    cur = torch.stack([lum, lum * lum])
    moments = torch.where(
        valid[None], (1 - alpha_m)[None] * prev_moments + alpha_m[None] * cur,
        cur)
    zero = scalar(0.0)
    variance = torch.maximum(moments[1] - moments[0] * moments[0], zero)
    if params["variance_boost_frames"] > 0:
        sm1, sm2 = spatial_moments(lum)
        var_spatial = torch.maximum(sm2 - sm1 * sm1, zero)
        variance = torch.where(n_new < params["variance_boost_frames"],
                               var_spatial, variance)
    new_hist = dict(color=integrated, moments=moments, length=n_new,
                    prev_depth=depth, prev_normal=n)
    return integrated, variance, new_hist


def denoise(g, hist, params):
    """Demodulate, temporal step, sweep, remodulate: ``(denoised,
    new_history)``, the history's colour the feedback level's output."""
    work = demodulate(g["render"], g["albedo"])
    integrated, variance, new_hist = temporal(g, hist, params, work)
    filtered, _, feedback = sweep(integrated, variance, g["normal"],
                                  g["depth"], params)
    new_hist["color"] = feedback
    return remodulate(filtered, g["albedo"]), new_hist
