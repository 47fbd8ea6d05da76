"""Edge-aware à-trous wavelet filter (SVGF spatial pass): the plain PyTorch
version.

Counterpart of ``raymarchdenoisercuda_tpu/ops/atrous.py``.  It is the CPU
path and the oracle that the CUDA kernels of ``ops/cuda/atrous.cu`` are held
against on the card: K1/K1b (the level forward, :func:`atrous_level_ref`),
K2/K2b (the stored-weight adjoint, :func:`atrous_level_bwd_stored_ref`),
K14 (the recompute adjoint, :func:`atrous_level_bwd_ref`) and K9 (the
adjoint through the weights, :func:`atrous_level_wgrad_bwd_ref`).  It is
never a fallback for a CUDA tensor.

Per level, at tap spacing ``s = 2^level``, for centre p and tap q = p + s·d:

* ``h(d) = taps[dy]·taps[dx]`` (B3 spline for radius 2, binomial otherwise);
* ``w = h · exp(−|z_p−z_q| / (σz·|∇z_p·(q−p)| + ε) − |l_p−l_q| / σden_p)
  · max(n_p·n_q, 0)^σn`` with ``σden = σl·sqrt(blur3x3(var)) + ε``;
* colour ``Σ w c_q / N`` and variance ``Σ w² v_q / N²``, ``N = max(Σ w, ε)``.

Out-of-image taps are dropped (zero weight).

Gradients: with ``detach_weights=True`` (the default, as in the JAX package)
the edge-stopping weights are constants for autograd, so a level is linear
in its colour and variance; ``detach_weights=False`` differentiates through
them.  The kernels' adjoints are written out explicitly: from stored
weights (:func:`atrous_level_bwd_stored_ref`, whose forward half is
``atrous_level_ref(..., return_weights=True)``, which also returns the tap
weights and the normaliser N), with the weights recomputed
(:func:`atrous_level_bwd_ref`), and through the weights
(:func:`atrous_level_wgrad_bwd_ref`, the explicit form of autograd with
``detach_weights=False`` and a given σ-denominator).

Tiles (``tile=Tile(origin, bounds)``, the sharded sweep's kernel forms):
the level and its adjoints compute the centre of a tile of the frame, read
the planes around a pixel from canvases (the tile plus a margin the halo
exchange filled) and drop a tap whose global coordinate lies outside the
frame, as the kernels do with their origin and bounds.  The adjoints can
write the gradients of the canvas margins too (``out_halo``).

``weight_math="fast"`` is the plain version of the TPU kernel's fast tap
weight (``ops/pallas/atrous_tpu.py`` ``_make_level_kernel(fast_weights=True)``),
which has no jnp oracle in the JAX package: the exponent moves to base 2,
the normal weight folds into it as ``−(c1·s + c2·s²)`` with
``s = |n_p − n_q|²`` (no ``max(n·n_q, 0)`` clamp), and one degree-3
polynomial ``2^y`` (``_exp2_fast3``) replaces exp and pow.

``precision="bf16"`` (K1b's and K14's bfloat16 form, the TPU kernel's
``dtype=jnp.bfloat16`` branch): the staged planes and the tap math are
bfloat16, each operation rounded once, the accumulators float32; the
normal weight is the exp-form one above, inside a degree-3 ``2^y`` built
in bfloat16 (:func:`exp2_fast_bf16`).  It has no jnp oracle either; its
twins (:func:`atrous_level_ref` and :func:`atrous_level_bwd_ref` with
``precision="bf16"``) follow the Pallas body operation by operation and
are held against the kernel in interpret mode.

``pyramid_from`` (``SVGFParams``): the levels from ``pyramid_from`` on run
at half resolution (:func:`_pyramid_deep_levels`), in the plain sweep only,
as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import SVGFParams, WAVELET_SPLINE_5
from ..gbuffer import luminance
from .common import (Tile, canvas_margin, crop, finite_diff_gradients,
                     global_mask, shift2d, valid_mask)

_EPS = 1e-8
_LUMA = (0.2126, 0.7152, 0.0722)   # Rec.709, as gbuffer.luminance
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# near-minimax degree-3 coefficients for exp(z) on [-ln2/2, ln2/2]; the
# values of ``_EXP3_C`` in the TPU kernel (max relative error 1.37e-4)
_EXP3_C = (0.999951338657045, 1.0001527445243588,
           0.5042261676140843, 0.16524081962961631)

WEIGHT_MATHS = ("exact", "fast")
PRECISIONS = ("f32", "bf16")


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
    weights renormalised.

    The numerator adds the 9 taps of the zero-padded plane in tap order
    (a dropped tap adds an exact zero, as K1's fused blur skips it); the
    normaliser, the sum of the in-image taps' weights, is the product of
    the row and column sums, exact in float (dyadic values).  Few launches:
    this blur is glue on the card's recompute and weight-gradient paths."""
    H, W = variance.shape
    k1 = (0.25, 0.5, 0.25)
    vp = F.pad(variance, (1, 1, 1, 1))
    num = torch.zeros_like(variance)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = k1[dy + 1] * k1[dx + 1]
            num = num + k * vp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return num / (_edge_sums(H, variance)[:, None]
                  * _edge_sums(W, variance)[None, :])


def variance_blur3x3_tile(variance: torch.Tensor, tile: Tile, H: int,
                          W: int) -> torch.Tensor:
    """:func:`variance_blur3x3` of an H x W tile from its variance canvas
    (margin >= 1): the taps outside the frame are dropped and the weights
    renormalised over the rest, in K1's order; a pixel outside the frame (a
    padded tile) has no such tap and gets 0."""
    m = canvas_margin(variance, H, W, "variance")
    k1 = (0.25, 0.5, 0.25)
    num = torch.zeros((H, W), dtype=variance.dtype, device=variance.device)
    den = torch.zeros_like(num)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            km = k1[dy + 1] * k1[dx + 1] * global_mask(
                tile, H, W, dy, dx, device=variance.device,
                dtype=variance.dtype)
            num = num + km * crop(variance, m, dy, dx, H, W)
            den = den + km
    return num / torch.clamp(den, min=1e-20)


def _edge_sums(n: int, like: torch.Tensor) -> torch.Tensor:
    """Σ of the in-range (¼, ½, ¼) weights along an axis of length n: 1,
    and ¾ at each end (½ where n = 1)."""
    s = torch.ones(n, dtype=like.dtype, device=like.device)
    s[0] -= 0.25
    s[-1] -= 0.25
    return s


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


def bf16_round(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even), from the
    double: the value the JAX package's bf16 kernel gives a Python
    constant, and the float that K1b's and K14's bf16 forms receive for
    it (exactly representable, so the card's conversion is exact)."""
    if x == 0.0 or not math.isfinite(x):
        return x
    _, e = math.frexp(x)
    return round(x * 2.0 ** (8 - e)) * 2.0 ** (e - 8)


def bf16_constants(params: SVGFParams) -> dict:
    """The constants of the bf16 tap math, each rounded by
    :func:`bf16_round`: the Rec.709 weights (``l0``-``l2``), ``ln2``,
    ``sixth`` (the Taylor term 1/6), ``floor`` (the exponent's clamp,
    −1e4), and the base-2 weight scales ``sz2`` = σz·ln2, ``eps2`` = ε·ln2,
    ``c_s1`` = σn·log2(e)/2 and ``c_s2`` = σn·log2(e)/8."""
    return {k: bf16_round(v) for k, v in (
        ("l0", _LUMA[0]), ("l1", _LUMA[1]), ("l2", _LUMA[2]),
        ("ln2", _LN2), ("sixth", 1.0 / 6.0), ("floor", -1e4),
        ("sz2", params.sigma_depth * _LN2), ("eps2", _EPS * _LN2),
        ("c_s1", params.sigma_normal * _LOG2E * 0.5),
        ("c_s2", params.sigma_normal * _LOG2E * 0.125))}


def exp2_fast_bf16(y: torch.Tensor, k: dict) -> torch.Tensor:
    """``2^y`` in bfloat16 for y <= 0 (the TPU kernel's ``_exp2_fast_bf16``),
    each operation rounded to bfloat16: y clamped at ``k["floor"]``,
    ``i = floor(y + ½)``, the degree-3 Taylor polynomial of ``e^z`` at
    ``z = (y − i)·ln2``, times ``2^i`` assembled in the bfloat16 bit layout
    (exponent field ``i + 127``, mantissa shift 7; i clipped to
    [−126, 127]).  ``k``: :func:`bf16_constants` as bfloat16 tensors."""
    y = torch.maximum(y, k["floor"])
    yi = torch.floor(y + k["half"])
    z = (y - yi) * k["ln2"]
    p = k["one"] + z * (k["one"] + z * (k["half"] + z * k["sixth"]))
    i = torch.clamp(yi.to(torch.int32), -126, 127)
    two_i = torch.bitwise_left_shift(i + 127, 7).to(torch.int16).view(
        torch.bfloat16)
    return p * two_i


def _bf16_tensors(params: SVGFParams, device) -> dict:
    """:func:`bf16_constants` (and ½, 1) as 0-dim bfloat16 tensors: a
    Python float in a bfloat16 operation would enter at float precision."""
    k = dict(bf16_constants(params), half=0.5, one=1.0)
    return {n: torch.tensor(v, dtype=torch.bfloat16, device=device)
            for n, v in k.items()}


def _bf16_taps(radius: int, device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.tensor(bf16_round(t), dtype=torch.bfloat16,
                              device=device) for t in _spline_taps(radius))


def _edge_weight_bf16(wz2, wl2, n_a, n_b, hfm, k):
    """``hfm·2^(wz2 + wl2 − (c1·s + c2·s²))``, ``s = |n_a − n_b|²``: the bf16
    tap weight of the TPU kernel's ``edge_weight``, in its operation order."""
    d0 = n_a[0] - n_b[0]
    d1 = n_a[1] - n_b[1]
    d2 = n_a[2] - n_b[2]
    s = d0 * d0 + d1 * d1 + d2 * d2
    arg = wz2 + wl2 - (k["c_s1"] * s + k["c_s2"] * (s * s))
    e = exp2_fast_bf16(arg, k)
    return hfm * e, hfm.to(torch.float32) * e.to(torch.float32)


def _log2e_over(sden: torch.Tensor) -> torch.Tensor:
    """``log2(e) / max(σ, ε)`` by a true float32 division, rounded to
    bfloat16 (the JAX package computes it outside the kernel and casts)."""
    return (torch.tensor(_LOG2E, dtype=torch.float32, device=sden.device)
            / torch.clamp(sden, min=_EPS)).to(torch.bfloat16)


def _atrous_level_bf16(color, variance, normal, depth, zgrad, sden, *,
                       level, params, return_weights):
    """K1b's bf16 form (``atrous_level_fwd_pallas(precision="bf16")``).

    Colour, variance, normal, depth and ``log2(e)/max(σ, ε)`` enter rounded
    to bfloat16; ∇z stays float32.  The luminance is Rec.709 in bfloat16
    from the rounded colour.  Per tap (dy-major), in bfloat16:
    ``hfm = (h_y·row mask)·(h_x·column mask)``, ``wl2 = −|l_c − l_q|·isd2``,
    ``wz2 = −|z_c − z_q|·rz`` with ``rz = 1/(sz2·|∇z·d| + eps2)`` taken in
    float32 and rounded, and the weight of :func:`_edge_weight_bf16`; each
    product ``w·c_q`` and ``(w·w)·v_q`` is rounded to bfloat16 and added to
    a float32 sum, as is ``w`` to N.  The end is float32: ``N = max(N, ε)``,
    ``c = Σ·(1/N)``, ``v = Σ·(1/N)²``.

    Both divisions in float32 (rz and 1/N) are true divisions here and in
    the kernel; the TPU kernel takes a Newton step from a bf16 reciprocal
    (``_recip``, ~2^-16 relative), which moves rz by a bfloat16 ulp now
    and then and the outputs by ~2^-16 relative.  Returns ``(c, v, N)``,
    or ``(c, v, weights, N)`` with the float32 values of the bf16 weights."""
    bf, f32 = torch.bfloat16, torch.float32
    dev = color.device
    H, W = depth.shape
    k = _bf16_tensors(params, dev)
    c, v = color.to(bf), variance.to(bf)
    n, z = normal.to(bf), depth.to(bf)
    lum = k["l0"] * c[0] + k["l1"] * c[1] + k["l2"] * c[2]
    isd2 = _log2e_over(sden)
    sz2 = torch.tensor(params.sigma_depth * _LN2, dtype=f32, device=dev)
    eps2 = torch.tensor(_EPS * _LN2, dtype=f32, device=dev)
    spacing, r = 1 << level, params.radius
    taps = _bf16_taps(r, dev)
    acc_c = torch.zeros((3, H, W), dtype=f32, device=dev)
    acc_v = torch.zeros((H, W), dtype=f32, device=dev)
    den = torch.zeros((H, W), dtype=f32, device=dev)
    weights = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing
            hfm = ((taps[dy + r] * valid_mask(H, 1, oy, 0, device=dev,
                                              dtype=bf))
                   * (taps[dx + r] * valid_mask(1, W, 0, ox, device=dev,
                                                dtype=bf)))
            c_q, v_q = shift2d(c, oy, ox), shift2d(v, oy, ox)
            l_q, n_q = shift2d(lum, oy, ox), shift2d(n, oy, ox)
            wl2 = -torch.abs(lum - l_q) * isd2
            rz = torch.reciprocal(
                sz2 * torch.abs(zgrad[0] * oy + zgrad[1] * ox) + eps2).to(bf)
            wz2 = -torch.abs(z - shift2d(z, oy, ox)) * rz
            w, w_f = _edge_weight_bf16(wz2, wl2, n, n_q, hfm, k)
            if return_weights:
                weights.append(w_f)
            acc_c = acc_c + w.to(f32)[None] * c_q.to(f32)
            acc_v = acc_v + (w * w).to(f32) * v_q.to(f32)
            den = den + w_f
    den = torch.clamp(den, min=_EPS)
    inv = torch.reciprocal(den)
    c_out, v_out = acc_c * inv[None], acc_v * (inv * inv)
    if return_weights:
        return c_out, v_out, torch.stack(weights), den
    return c_out, v_out, den


def _atrous_level_bwd_bf16(color, normal, depth, zgrad, sden, norm, gc, gv, *,
                           level, params):
    """K14's bf16 form (``atrous_level_bwd_pallas(precision="bf16")``).

    Enter rounded to bfloat16: the float32 luminance, normal, depth,
    ``log2(e)/max(σ, ε)``, ∇z, ``u = gc/max(N, ε)`` and ``u2 = gv/max(N, ε)²``
    (the quotients in float32, true divisions).  Per tap d (dy-major), for
    the centre p = x − d·2^level, in bfloat16: the masks of p (in the
    image), ``rz = 1/(sz2·|∇z_p·d| + eps2)`` (the bfloat16 quotient),
    ``wz2 = −|z_p − z_x|·rz``, ``wl2 = −|l_p − l_x|·isd2_p`` and p's weight
    of :func:`_edge_weight_bf16`; each product ``w·u_p`` and ``(w·w)·u2_p``
    is rounded to bfloat16 and added to a float32 sum.  Returns
    ``(d_color, d_variance)``."""
    bf, f32 = torch.bfloat16, torch.float32
    dev = color.device
    H, W = depth.shape
    k = _bf16_tensors(params, dev)
    lum = luminance(color).to(bf)
    n, z, zg = normal.to(bf), depth.to(bf), zgrad.to(bf)
    isd2 = _log2e_over(sden)
    inv_n = torch.reciprocal(torch.clamp(norm, min=_EPS))
    u = (gc * inv_n[None]).to(bf)
    u2 = (gv * (inv_n * inv_n)).to(bf)
    spacing, r = 1 << level, params.radius
    taps = _bf16_taps(r, dev)
    acc_c = torch.zeros((3, H, W), dtype=f32, device=dev)
    acc_v = torch.zeros((H, W), dtype=f32, device=dev)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing

            def at_p(x):
                return shift2d(x, -oy, -ox)

            hfm = ((taps[dy + r] * valid_mask(H, 1, -oy, 0, device=dev,
                                              dtype=bf))
                   * (taps[dx + r] * valid_mask(1, W, 0, -ox, device=dev,
                                                dtype=bf)))
            zg_p = at_p(zg)
            dz2 = (k["sz2"] * torch.abs(
                zg_p[0] * torch.tensor(float(oy), dtype=bf, device=dev)
                + zg_p[1] * torch.tensor(float(ox), dtype=bf, device=dev))
                + k["eps2"])
            rz = k["one"] / dz2
            wz2 = -torch.abs(at_p(z) - z) * rz
            wl2 = -torch.abs(at_p(lum) - lum) * at_p(isd2)
            w, _ = _edge_weight_bf16(wz2, wl2, at_p(n), n, hfm, k)
            acc_c = acc_c + w.to(f32)[None] * at_p(u).to(f32)
            acc_v = acc_v + (w * w).to(f32) * at_p(u2).to(f32)
    return acc_c, acc_v


def sigma_denominator(variance: torch.Tensor, params: SVGFParams, *,
                      tile: Tile = None, shape=None) -> torch.Tensor:
    """``σ_l·sqrt(max(blur3x3(var), 0)) + ε``: the luminance weight's
    denominator of a level (what K1 fuses and K1b takes as an input); with
    ``tile``, of the ``shape`` = (H, W) tile from its variance canvas."""
    blur = (variance_blur3x3(variance) if tile is None
            else variance_blur3x3_tile(variance, tile, *shape))
    return params.sigma_color * torch.sqrt(torch.clamp(blur, min=0.0)) + _EPS


def _tap_weights(lum, normal, depth, zgrad, sden, *, level, params,
                 weight_math="exact", luma_only=False, tile=None):
    """Yields ``(oy, ox, w)`` for each tap (dy-major, tap k = (dy+r)(2r+1) +
    (dx+r)): the (H, W) weight of the centres' tap at offset (oy, ox), ``h``
    and the border mask included.  The exact weight is
    ``h·exp(wz + wl)·pow(max(ndot, 1e-20), σn)`` in the operation order of
    K1 (``atrous.cu``), which K14 and K9 recompute.  With ``tile``,
    ``lum``, ``normal`` and ``depth`` are canvases around the (H, W) tile
    of ``zgrad``, and the mask is the frame's."""
    H, W = zgrad.shape[-2:]
    lum_q_of, normal_q_of, depth_q_of = lum, normal, depth
    if tile is None:
        def at_l(x, oy, ox):
            return shift2d(x, oy, ox)

        at_g = at_l

        def mask(oy, ox):
            return valid_mask(H, W, oy, ox, device=depth.device,
                              dtype=depth.dtype)
    else:
        ml = canvas_margin(lum, H, W, "colour")
        mg = canvas_margin(depth, H, W, "depth")

        def at_l(x, oy, ox):
            return crop(x, ml, oy, ox, H, W)

        def at_g(x, oy, ox):
            return crop(x, mg, oy, ox, H, W)

        def mask(oy, ox):
            return global_mask(tile, H, W, oy, ox, device=depth.device,
                               dtype=depth.dtype)

        lum, normal, depth = (at_l(lum, 0, 0), at_g(normal, 0, 0),
                              at_g(depth, 0, 0))
    spacing = 1 << level
    r = params.radius
    taps1d = _spline_taps(r)
    fast = weight_math == "fast"
    if fast:
        # log2(e) folded into the reciprocal scales: the exponent is base 2
        isd2 = _LOG2E / torch.clamp(sden, min=_EPS)
        sz2 = params.sigma_depth * _LN2
        eps2 = _EPS * _LN2
        c_s1 = params.sigma_normal * _LOG2E * 0.5
        c_s2 = params.sigma_normal * _LOG2E * 0.125
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing
            h = taps1d[dy + r] * taps1d[dx + r]
            m = mask(oy, ox)
            l_q = at_l(lum_q_of, oy, ox)
            if not luma_only:
                z_q = at_g(depth_q_of, oy, ox)
                n_q = at_g(normal_q_of, oy, ox)
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
            yield oy, ox, w


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
    sigma_denom: torch.Tensor = None,  # (H, W); from the variance if None
    tile: Tile = None,
    precision: str = "f32",
):
    """One à-trous level.  Returns (filtered colour, filtered variance), and
    with ``return_weights`` also the (n_taps, H, W) tap weights in the
    input's dtype (``h·mask`` included, so out-of-image taps are 0; tap k =
    (dy+r)(2r+1) + (dx+r)) and the normaliser ``N = max(Σ w, ε)``, which
    the stored-weight adjoint consumes.

    ``sigma_denom`` given: the luminance weight divides by it instead of
    by :func:`sigma_denominator` of ``variance`` (``atrous_level_fwd_pallas``'s
    input, K1b's); with ``detach_weights=False`` gradients then reach it,
    and ``variance`` only through the data term.

    ``tile`` given (K1's and K1b's tile form): ``color``/``variance`` and
    ``normal``/``depth`` are canvases around the tile of ``zgrad`` (which
    is then required), margins >= the level's reach r·2^level (and >= 1
    for the fused σ blur); the outputs are the tile's.

    ``precision="bf16"``: K1b's bfloat16 form (:func:`_atrous_level_bf16`),
    with a given ``sigma_denom`` and exact-mode weights, on the whole
    frame, without gradients (the weights are detached; as in the JAX
    package, the bf16 level is differentiated by its adjoint kernels)."""
    if weight_math not in WEIGHT_MATHS:
        raise ValueError(f"unknown weight_math: {weight_math!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "bf16":
        if sigma_denom is None or weight_math != "exact" or tile is not None:
            raise ValueError("precision='bf16' is the per-level form: it "
                             "takes a sigma_denom, exact weight_math and "
                             "the whole frame")
        if zgrad is None:
            zgrad = finite_diff_gradients(depth)
        with torch.no_grad():
            out = _atrous_level_bf16(color, variance, normal, depth, zgrad,
                                     sigma_denom, level=level, params=params,
                                     return_weights=return_weights)
        return out if return_weights else out[:2]
    if zgrad is None:
        if tile is not None:
            raise ValueError("the tile form needs the tile's zgrad")
        zgrad = finite_diff_gradients(depth)
    H, W = zgrad.shape[-2:]
    if tile is None:
        def at(x, oy, ox):
            return shift2d(x, oy, ox)
    else:
        md = canvas_margin(color, H, W, "color")

        def at(x, oy, ox):
            return crop(x, md, oy, ox, H, W)

    lum = luminance(color)
    var_w = variance
    if detach_weights:
        lum, var_w = lum.detach(), variance.detach()
    sden = (sigma_denominator(var_w, params, tile=tile, shape=(H, W))
            if sigma_denom is None else sigma_denom)

    num_c = torch.zeros((3, H, W), dtype=color.dtype, device=color.device)
    num_v = torch.zeros((H, W), dtype=color.dtype, device=color.device)
    den = torch.zeros_like(num_v)

    luma_only = (params.luma_only_from is not None
                 and level >= params.luma_only_from)
    weights = []
    for oy, ox, w in _tap_weights(lum, normal, depth, zgrad, sden,
                                  level=level, params=params,
                                  weight_math=weight_math,
                                  luma_only=luma_only, tile=tile):
        if detach_weights:
            w = w.detach()
        if return_weights:
            weights.append(w)

        num_c = num_c + w[None] * at(color, oy, ox)
        num_v = num_v + (w * w) * at(variance, oy, ox)
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
    out_halo: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (bf16 weights) and K2b (float32 weights): the
    detached adjoint of one level from the forward's stored weights.

    With ``u = gc/max(N, ε)`` and ``u2 = gv/max(N, ε)²`` at each centre p,
    ``dc_x = Σ_d w_{x−d}(d)·u_{x−d}`` and ``dv_x = Σ_d w_{x−d}(d)²·u2_{x−d}``
    (taps at spacing 2^level, summed in tap order, each weight widened to
    the cotangent's dtype first).  ``out_halo`` = o > 0 (the tile form):
    the gradients of the (H + 2o, W + 2o) canvas around the tile, margins
    included, from the tile's centres.  Returns ``(d_color, d_variance)``."""
    if out_halo:
        o = out_halo
        w, norm, gc, gv = (F.pad(t, (o, o, o, o)) for t in (w, norm, gc, gv))
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
            w_sh = shift2d(w[k].to(gc.dtype), oy, ox)
            acc_c = acc_c + w_sh[None] * shift2d(u, oy, ox)
            acc_v = acc_v + (w_sh * w_sh) * shift2d(u2, oy, ox)
    return acc_c, acc_v


def atrous_level_bwd_ref(
    color: torch.Tensor,        # (3, H, W) the level's input colour
    normal: torch.Tensor,       # (3, H, W)
    depth: torch.Tensor,        # (H, W)
    zgrad: torch.Tensor,        # (2, H, W)
    sigma_denom: torch.Tensor,  # (H, W) the forward's σ-denominator
    norm: torch.Tensor,         # (H, W) N of the forward
    gc: torch.Tensor,           # (3, H, W) cotangent of the filtered colour
    gv: torch.Tensor,           # (H, W) cotangent of the filtered variance
    *,
    level: int,
    params: SVGFParams,
    tile: Tile = None,
    out_halo: int = 0,
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14: the detached adjoint of one level with the
    weights recomputed (``atrous_level_bwd_pallas``; no weight storage).
    ``tile`` and ``out_halo`` as in :func:`atrous_level_ref` and
    :func:`atrous_level_bwd_stored_ref` (``color``, ``normal`` and
    ``depth`` are then canvases, margins >= the level's reach).

    Each tap's weight is recomputed at every centre p from p's luminance,
    normal, depth, ∇z and σ-denominator and the neighbour's, by the exact
    weight math of the forward (the same operations in the same order, so
    the adjoint is the exact transpose of the forward's stencil), then
    gathered as in :func:`atrous_level_bwd_stored_ref`: ``dc_x = Σ_d
    w_{x−d}(d)·g_{x−d}/N_{x−d}`` and ``dv_x = Σ_d w_{x−d}(d)²·gv_{x−d}/
    N_{x−d}²``.  Exact weights only, full (not luma-only) levels, as in the
    JAX package.  Returns ``(d_color, d_variance)``.

    ``precision="bf16"``: K14's bfloat16 form (:func:`_atrous_level_bwd_bf16`),
    the adjoint of ``atrous_level_ref(..., precision="bf16")``'s stencil,
    on the whole frame."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "bf16":
        if tile is not None or out_halo:
            raise ValueError("precision='bf16' takes the whole frame (no "
                             "tile or out_halo)")
        return _atrous_level_bwd_bf16(color, normal, depth, zgrad,
                                      sigma_denom, norm, gc, gv, level=level,
                                      params=params)
    lum = luminance(color)
    w = torch.stack([w for _, _, w in _tap_weights(
        lum, normal, depth, zgrad, sigma_denom, level=level, params=params,
        tile=tile)])
    return atrous_level_bwd_stored_ref(w, norm, gc, gv, level=level,
                                       radius=params.radius,
                                       out_halo=out_halo)


def atrous_level_wgrad_bwd_ref(
    color, variance, normal, depth, zgrad, sigma_denom,
    out_c, out_v, norm, gc, gv, *, level: int, params: SVGFParams,
):
    """Plain version of K9: the full adjoint of one level, through the
    edge-stopping weights (``atrous_level_wgrad_bwd_pallas``), written out
    as an explicit adjoint (not autograd) in the operations of the two CUDA
    kernels.  Returns ``(d_color, d_variance, d_normal, d_depth, d_zgrad,
    d_sigma_denom)``: the gradients of ``atrous_level_ref(...,
    sigma_denom=σ, zgrad=∇z, detach_weights=False)`` with respect to its
    inputs, for cotangents ``gc``, ``gv`` of its outputs ``out_c``,
    ``out_v`` (and its normaliser ``norm``).

    With ``A_p(d) = ∂L/∂w_p(d) = [gc_p·(c_q − out_c_p) + gv_p·(2·w·v_q/N_p
    − 2·out_v_p)]/N_p`` for centre p and neighbour q = p + d·2^level, and
    ``w = h·exp(−|z_p − z_q|·rz − |l_p − l_q|/σ_p)·max(n_p·n_q, 0)^σn``
    with ``rz = 1/(σz·|∇z_p·d| + ε)``, each input gets ``Σ A·∂w/∂θ`` in two
    shapes:

    * centre terms (θ at p, over p's own taps; K9's first kernel): normal,
      depth, ∇z, σ and luminance;
    * neighbour terms (θ at q, gathered at x over the centres p = x − d;
      K9's second kernel): normal, depth and luminance, with the detached
      data stencil of colour and variance riding along.

    The luminance gradient folds into d_color by the Rec.709 weights.  The
    derivative of ``|·|`` at 0 is 0 (``sign(0)``), as in the TPU kernel and
    in PyTorch's autograd; exact ``exp`` and ``pow``, not the TPU's
    polynomial and Newton reciprocals."""
    sz, sn = params.sigma_depth, params.sigma_normal
    lum = luminance(color)
    inv_n = 1.0 / torch.clamp(norm, min=_EPS)
    isd = 1.0 / sigma_denom

    # centre terms: x is the centre, q = x + d its neighbour
    dn_c = torch.zeros_like(normal)
    dz_c = torch.zeros_like(depth)
    dzg0 = torch.zeros_like(depth)
    dzg1 = torch.zeros_like(depth)
    dsd = torch.zeros_like(depth)
    dl_c = torch.zeros_like(depth)
    for oy, ox, w in _tap_weights(lum, normal, depth, zgrad, sigma_denom,
                                  level=level, params=params):
        c_q = shift2d(color, oy, ox)
        v_q = shift2d(variance, oy, ox)
        n_q = shift2d(normal, oy, ox)
        dz = depth - shift2d(depth, oy, ox)
        dl = lum - shift2d(lum, oy, ox)
        zs = zgrad[0] * oy + zgrad[1] * ox
        rz = 1.0 / (sz * torch.abs(zs) + _EPS)
        ndot = torch.clamp(normal[0] * n_q[0] + normal[1] * n_q[1]
                           + normal[2] * n_q[2], min=0.0)
        a = ((gc[0] * (c_q[0] - out_c[0]) + gc[1] * (c_q[1] - out_c[1])
              + gc[2] * (c_q[2] - out_c[2]))
             + gv * (2.0 * w * v_q * inv_n - 2.0 * out_v)) * inv_n
        b = a * w
        dz_c = dz_c - b * torch.sign(dz) * rz
        dl_c = dl_c - b * torch.sign(dl) * isd
        dsd = dsd + b * torch.abs(dl) * (isd * isd)
        gz = b * torch.abs(dz) * (rz * rz) * sz * torch.sign(zs)
        dzg0 = dzg0 + gz * oy
        dzg1 = dzg1 + gz * ox
        nf = b * sn / torch.clamp(ndot, min=1e-20)
        dn_c = dn_c + nf[None] * n_q

    # neighbour terms: x is the neighbour of the centres p = x − d; the
    # centres' weights are the same planes, read shifted by −d
    dc = torch.zeros_like(color)
    dv = torch.zeros_like(variance)
    dn_n = torch.zeros_like(normal)
    dz_n = torch.zeros_like(depth)
    dl_n = torch.zeros_like(depth)
    u = gc * inv_n[None]
    u2 = gv * (inv_n * inv_n)
    for oy, ox, w in _tap_weights(lum, normal, depth, zgrad, sigma_denom,
                                  level=level, params=params):
        def at_p(t):
            return shift2d(t, -oy, -ox)

        w = at_p(w)
        n_p, gc_p, oc_p, invn_p = at_p(normal), at_p(gc), at_p(out_c), at_p(
            inv_n)
        dz = at_p(depth) - depth
        dl = at_p(lum) - lum
        zg_p = at_p(zgrad)
        rz = 1.0 / (sz * torch.abs(zg_p[0] * oy + zg_p[1] * ox) + _EPS)
        ndot = torch.clamp(n_p[0] * normal[0] + n_p[1] * normal[1]
                           + n_p[2] * normal[2], min=0.0)
        # the detached data stencil (K14's sum)
        dc = dc + w[None] * at_p(u)
        dv = dv + (w * w) * at_p(u2)
        a = ((gc_p[0] * (color[0] - oc_p[0]) + gc_p[1] * (color[1] - oc_p[1])
              + gc_p[2] * (color[2] - oc_p[2]))
             + at_p(gv) * (2.0 * w * variance * invn_p - 2.0 * at_p(out_v))
             ) * invn_p
        b = a * w
        dz_n = dz_n + b * torch.sign(dz) * rz
        dl_n = dl_n + b * torch.sign(dl) * at_p(isd)
        nf = b * sn / torch.clamp(ndot, min=1e-20)
        dn_n = dn_n + nf[None] * n_p

    d_lum = dl_c + dl_n
    d_color = torch.stack([dc[k] + lk * d_lum
                           for k, lk in enumerate(_LUMA)])
    return (d_color, dv, dn_c + dn_n, dz_c + dz_n,
            torch.stack([dzg0, dzg1]), dsd)


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

    With ``params.pyramid_from`` = P below ``iterations``, levels P and up
    run at half resolution (:func:`_pyramid_deep_levels`); the feedback
    level must then be a full-resolution one (``feedback_level <= P``, else
    ``ValueError``, as in the JAX package).
    """
    zgrad = finite_diff_gradients(depth)
    c, v = color, variance
    feedback = color
    pf = params.pyramid_from
    n_full = params.iterations if pf is None else min(pf, params.iterations)
    for lvl in range(n_full):
        c, v = atrous_level_ref(c, v, normal, depth, zgrad, level=lvl,
                                params=params, weight_math=weight_math,
                                detach_weights=detach_weights)
        if lvl + 1 == params.feedback_level:
            feedback = c
    if pf is not None and pf < params.iterations:
        if params.feedback_level > pf:
            raise ValueError("pyramid_from requires feedback_level <= "
                             "pyramid_from (the feedback plane must be a "
                             "full-resolution level)")
        c, v = _pyramid_deep_levels(c, v, normal, depth, params=params,
                                    weight_math=weight_math,
                                    detach_weights=detach_weights)
    if return_feedback:
        return c, v, feedback
    return c, v


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x2-mean downsample of a (…, H, W) plane; an odd extent repeats its
    last row (column) first."""
    H, W = x.shape[-2:]
    if H % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if W % 2:
        x = torch.cat([x, x[..., :, -1:]], dim=-1)
    Hp, Wp = x.shape[-2:]
    x = x.reshape(x.shape[:-2] + (Hp // 2, 2, Wp // 2, 2))
    return x.mean(dim=(-3, -1))


def _up2(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear 2x upsample of a (…, h, w) plane at half-pixel centres (the
    phase of :func:`_down2`; ``jax.image.resize(..., "bilinear")``, whose
    dropped border taps renormalise to the edge sample as the clamped
    source index does here), cropped to H x W."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1) + x.shape[-2:]), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y.reshape(lead + y.shape[-2:])[..., :H, :W]


def _pyramid_deep_levels(c, v, normal, depth, *, params, weight_math,
                         detach_weights):
    """The levels ``pyramid_from…iterations−1`` at half resolution
    (``SVGFParams.pyramid_from``, the JAX package's experiment): colour,
    variance, normal (renormalised, ``max(‖n‖, 1e-8)``) and depth are 2x2-
    mean downsampled, ∇z taken of the coarse depth, each level runs with
    its index less one (the same footprint in the image at half the
    pixels), and the coarse levels' change is upsampled and added to the
    full-resolution planes (the variance clamped at 0)."""
    H, W = depth.shape
    cd, vd = _down2(c), _down2(v)
    nd = _down2(normal)
    nd = nd / torch.clamp(torch.linalg.vector_norm(nd, dim=0, keepdim=True),
                          min=1e-8)
    zd = _down2(depth)
    zgd = finite_diff_gradients(zd)
    c2, v2 = cd, vd
    for lvl in range(params.pyramid_from, params.iterations):
        c2, v2 = atrous_level_ref(c2, v2, nd, zd, zgd, level=lvl - 1,
                                  params=params, weight_math=weight_math,
                                  detach_weights=detach_weights)
    c_out = c + _up2(c2 - cd, H, W)
    v_out = torch.clamp(v + _up2(v2 - vd, H, W), min=0.0)
    return c_out, v_out
