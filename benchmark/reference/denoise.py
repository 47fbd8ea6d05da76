"""Plain PyTorch reference of the SVGF denoiser (Schied et al., HPG 2017,
sections 4-5): albedo demodulation, the temporal step (bounded bilinear
reprojection, validity tests, history clamp, exponential blend, moments
and the spatial variance fallback), the à-trous sweep with exact
edge-stopping weights, and remodulation.

A frozen copy of the arithmetic of the port's plain path
(``temporal_accumulate`` with bounded motion, ``svgf_spatial_ref`` with
``weight_math="exact"``); it imports nothing of the program.  The
edge-stopping weights are constants for autograd, as in the program.
Every function runs in the dtype of its inputs.  ``params`` is the
configuration's ``svgf`` dict (the program's ``SVGFParams`` fields).

A G-buffer is a dict of ``render``, ``albedo``, ``normal`` (3, H, W),
``depth`` (H, W) and ``motion`` (2, H, W); a history a dict of ``color``
(3, H, W), ``moments`` (2, H, W), ``length``, ``prev_depth`` (H, W) and
``prev_normal`` (3, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-8
ALBEDO_EPS = 1e-3
EMISSIVE_THRESH = 0.02
B3_SPLINE = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
HISTORY_KEYS = ("color", "moments", "length", "prev_depth", "prev_normal")


def luminance(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def zero_history(height, width, *, dtype, device):
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)
    return dict(color=z(3, height, width), moments=z(2, height, width),
                length=z(height, width), prev_depth=z(height, width),
                prev_normal=z(3, height, width))


def shift(x, dy, dx):
    """``y[..., i, j] = x[..., i + dy, j + dx]``, zero out of range."""
    if dy == 0 and dx == 0:
        return x
    H, W = x.shape[-2:]
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    ys, xs = max(dy, 0), max(dx, 0)
    return xp[..., ys:ys + H, xs:xs + W]


def in_range(H, W, dy, dx, *, device, dtype):
    iy = torch.arange(H, device=device)[:, None]
    ix = torch.arange(W, device=device)[None, :]
    return (((iy + dy >= 0) & (iy + dy < H))
            & ((ix + dx >= 0) & (ix + dx < W))).to(dtype)


def fma(a, b, c):
    """``a·b + c`` rounded once (float64 holds the product exactly)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def tent(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def demodulate(color, albedo):
    lit = torch.amax(albedo, dim=0, keepdim=True) > EMISSIVE_THRESH
    return torch.where(lit, color / torch.clamp(albedo, min=ALBEDO_EPS),
                       color)


def remodulate(irr, albedo):
    lit = torch.amax(albedo, dim=0, keepdim=True) > EMISSIVE_THRESH
    return torch.where(lit, irr * torch.clamp(albedo, min=ALBEDO_EPS), irr)


# -- temporal step ----------------------------------------------------------

def reproject(stack, motion, max_motion):
    """Bilinear (tent) gather of a (P, H, W) stack at p + motion; a pixel
    whose |dy| or |dx| exceeds ``max_motion`` reads zero, as does a tap
    outside the image.  The four taps accumulate by fused multiply-adds."""
    P, H, W = stack.shape
    m0, m1 = motion[0], motion[1]
    within = (torch.abs(m0) <= max_motion) & (torch.abs(m1) <= max_motion)
    m0w = torch.where(within, m0, torch.zeros_like(m0))
    m1w = torch.where(within, m1, torch.zeros_like(m1))
    y0, x0 = torch.floor(m0w), torch.floor(m1w)
    iy = torch.arange(H, device=stack.device)[:, None]
    ix = torch.arange(W, device=stack.device)[None, :]
    flat = stack.reshape(P, -1)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    out = torch.zeros((P, H, W), dtype=stack.dtype, device=stack.device)
    for ay in (0, 1):
        dyf = y0 + ay
        ty = tent(m0w - dyf)
        for ax in (0, 1):
            dxf = x0 + ax
            tx = tent(m1w - dxf)
            ry = iy + dyf.to(torch.int64)
            rx = ix + dxf.to(torch.int64)
            inside = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W) & within
            idx = (torch.clamp(ry, 0, H - 1) * W
                   + torch.clamp(rx, 0, W - 1)).reshape(-1)
            val = torch.where(inside[None], flat[:, idx].reshape(P, H, W),
                              zero)
            out = fma((ty * tx)[None], val, out)
    return out


def neighbourhood_minmax(color, radius=1):
    """3x3 min/max of ``color``, out-of-image taps dropped (rows, then
    columns)."""
    H, W = color.shape[-2:]
    inf = torch.tensor(float("inf"), dtype=color.dtype, device=color.device)

    def one_axis(lo, hi, along_y):
        olo, ohi = lo, hi
        for d in range(-radius, radius + 1):
            if d == 0:
                continue
            dy, dx = (d, 0) if along_y else (0, d)
            m = in_range(H, W, dy, dx, device=color.device,
                         dtype=color.dtype) > 0
            olo = torch.minimum(olo, torch.where(m, shift(lo, dy, dx), inf))
            ohi = torch.maximum(ohi, torch.where(m, shift(hi, dy, dx), -inf))
        return olo, ohi

    cmin, cmax = one_axis(color, color, True)
    return one_axis(cmin, cmax, False)


def spatial_moments(lum, radius=3):
    """(E[l], E[l²]) over a 7x7 window, over the in-image taps."""
    H, W = lum.shape

    def winsum(x):
        rows = x
        for d in range(1, radius + 1):
            rows = rows + shift(x, d, 0) + shift(x, -d, 0)
        out = rows
        for d in range(1, radius + 1):
            out = out + shift(rows, 0, d) + shift(rows, 0, -d)
        return out

    iy = torch.arange(H, dtype=lum.dtype, device=lum.device)[:, None]
    ix = torch.arange(W, dtype=lum.dtype, device=lum.device)[None, :]
    cy = (torch.clamp(iy, max=float(radius))
          + torch.clamp(H - 1 - iy, max=float(radius)) + 1.0)
    cx = (torch.clamp(ix, max=float(radius))
          + torch.clamp(W - 1 - ix, max=float(radius)) + 1.0)
    inv = 1.0 / (cy * cx)
    return winsum(lum) * inv, winsum(lum * lum) * inv


def temporal(g, hist, params, render):
    """One temporal step of the (demodulated) ``render``: returns
    ``(integrated, variance, new_history)``."""
    H, W = g["depth"].shape
    motion = g["motion"]
    stack = torch.cat([hist["color"], hist["moments"], hist["length"][None],
                       hist["prev_depth"][None], hist["prev_normal"]])
    gathered = reproject(stack, motion, params["max_motion"])
    prev_color, prev_moments = gathered[0:3], gathered[3:5]
    prev_len, prev_depth, prev_normal = gathered[5], gathered[6], gathered[7:]
    iy = torch.arange(H, dtype=motion.dtype, device=motion.device)[:, None]
    ix = torch.arange(W, dtype=motion.dtype, device=motion.device)[None, :]
    ys, xs = iy + motion[0], ix + motion[1]
    M = params["max_motion"]
    in_bounds = ((ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
                 & (torch.abs(motion[0]) <= M) & (torch.abs(motion[1]) <= M))
    depth, n = g["depth"], g["normal"]
    depth_ok = torch.abs(prev_depth - depth) <= 0.1 * torch.clamp(
        torch.abs(depth), min=1e-3)
    ndot = (prev_normal[0] * n[0] + prev_normal[1] * n[1]
            + prev_normal[2] * n[2])
    valid = in_bounds & depth_ok & (ndot > 0.8) & (prev_len > 0)
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


# -- à-trous sweep ----------------------------------------------------------

def spline_taps(radius):
    """1-D kernel profile: the B3 spline at radius 2, binomial otherwise."""
    if radius == 2:
        return B3_SPLINE
    n = 2 * radius
    taps = [math.comb(n, k) for k in range(n + 1)]
    s = float(sum(taps))
    return tuple(t / s for t in taps)


def depth_gradient(z):
    """Central differences (dz/dy, dz/dx), one-sided at the borders."""
    H, W = z.shape
    fy, by = shift(z, 1, 0) - z, z - shift(z, -1, 0)
    fx, bx = shift(z, 0, 1) - z, z - shift(z, 0, -1)
    iy = torch.arange(H, device=z.device)[:, None]
    ix = torch.arange(W, device=z.device)[None, :]
    dzdy = torch.where(iy == 0, fy, torch.where(iy == H - 1, by,
                                                0.5 * (fy + by)))
    dzdx = torch.where(ix == 0, fx, torch.where(ix == W - 1, bx,
                                                0.5 * (fx + bx)))
    return torch.stack([dzdy, dzdx])


def variance_blur3x3(v):
    """3x3 (¼, ½, ¼)² blur, border taps dropped and renormalised."""
    H, W = v.shape
    k1 = (0.25, 0.5, 0.25)
    vp = F.pad(v, (1, 1, 1, 1))
    num = torch.zeros_like(v)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            num = num + (k1[dy + 1] * k1[dx + 1]) * vp[1 + dy:1 + dy + H,
                                                      1 + dx:1 + dx + W]

    def edge(n):
        s = torch.ones(n, dtype=v.dtype, device=v.device)
        s[0] -= 0.25
        s[-1] -= 0.25
        return s

    return num / (edge(H)[:, None] * edge(W)[None, :])


def atrous_level(color, variance, normal, depth, zgrad, level, params):
    """One à-trous level at tap spacing 2^level with the exact weight
    ``h·exp(−|Δz|/(σz·|∇z·Δp| + ε) − |Δl|/σden)·max(n·n_q, 0)^σn``;
    returns the filtered colour and variance."""
    H, W = depth.shape
    lum = luminance(color).detach()
    sden = (params["sigma_color"] * torch.sqrt(torch.clamp(
        variance_blur3x3(variance.detach()), min=0.0)) + EPS)
    r = params["radius"]
    taps = spline_taps(r)
    s = 1 << level
    num_c = torch.zeros((3, H, W), dtype=color.dtype, device=color.device)
    num_v = torch.zeros((H, W), dtype=color.dtype, device=color.device)
    den = torch.zeros_like(num_v)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * s, dx * s
            h = taps[dy + r] * taps[dx + r]
            m = in_range(H, W, oy, ox, device=depth.device, dtype=depth.dtype)
            with torch.no_grad():
                l_q = shift(lum, oy, ox)
                z_q = shift(depth, oy, ox)
                n_q = shift(normal, oy, ox)
                zdot = torch.abs(zgrad[0] * oy + zgrad[1] * ox)
                wl = -torch.abs(lum - l_q) / sden
                wz = -torch.abs(depth - z_q) / (params["sigma_depth"] * zdot
                                                + EPS)
                ndot = torch.clamp(normal[0] * n_q[0] + normal[1] * n_q[1]
                                   + normal[2] * n_q[2], min=0.0)
                wn = torch.pow(torch.clamp(ndot, min=1e-20),
                               params["sigma_normal"])
                w = h * m * torch.exp(wz + wl) * wn
            num_c = num_c + w[None] * shift(color, oy, ox)
            num_v = num_v + (w * w) * shift(variance, oy, ox)
            den = den + w
    den = torch.clamp(den, min=EPS)
    return num_c / den[None], num_v / (den * den)


def sweep(color, variance, normal, depth, params):
    """The ``iterations``-level sweep: ``(colour, variance, feedback)``, the
    feedback the colour after ``feedback_level`` levels."""
    zgrad = depth_gradient(depth)
    c, v, feedback = color, variance, color
    for lvl in range(params["iterations"]):
        c, v = atrous_level(c, v, normal, depth, zgrad, lvl, params)
        if lvl + 1 == params["feedback_level"]:
            feedback = c
    return c, v, feedback


def denoise(g, hist, params):
    """Demodulate, temporal step, sweep, remodulate: ``(denoised,
    new_history)``, the history's colour the feedback level's output."""
    work = demodulate(g["render"], g["albedo"])
    integrated, variance, new_hist = temporal(g, hist, params, work)
    filtered, _, feedback = sweep(integrated, variance, g["normal"],
                                  g["depth"], params)
    new_hist["color"] = feedback
    return remodulate(filtered, g["albedo"]), new_hist
