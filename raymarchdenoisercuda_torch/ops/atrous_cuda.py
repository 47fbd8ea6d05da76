"""The à-trous SVGF sweep through the CUDA level kernels, in every adjoint
mode of ``svgf_spatial_pallas`` (``raymarchdenoisercuda_tpu/ops/pallas/
atrous_tpu.py``).

Sweeps:

* :func:`svgf_spatial_cuda` is ``bwd_impl="none"``, the inference sweep (K1
  without weight writes; no gradient: it raises on an input that requires
  grad);
* :func:`svgf_spatial_stored_cuda` is ``bwd_impl="stored"``, the
  ``torch.autograd.Function`` counterpart of ``_svgf_chained``: K1 in store
  mode keeps each level's bf16 tap weights and N, and the backward runs K2
  level by level in reverse;
* :func:`svgf_spatial_ad_cuda` has ``svgf_spatial_pallas``'s whole keyword
  surface: the two above, ``"stored_f32"`` (K1 storing float weights, K2b),
  ``"recompute"`` and ``chained=False`` (K1b, then K14),
  ``weight_grads=True`` (K1b, then K9: gradients through the weights), and
  ``precision="bf16"`` (the bfloat16 forms of K1b and K14, level by level).

Per-level wrappers, one for each JAX function: :func:`atrous_level_cuda`
(K1, ``atrous_level_fwd_canvas``), :func:`atrous_level_fwd_cuda` (K1b,
``atrous_level_fwd_pallas``), :func:`atrous_level_bwd_stored_cuda` (K2/K2b,
``atrous_level_bwd_stored_canvas``/``_pallas``), :func:`atrous_level_bwd_cuda`
(K14, ``atrous_level_bwd_pallas``) and :func:`atrous_level_wgrad_bwd_cuda`
(K9, ``atrous_level_wgrad_bwd_pallas``).  Each launches its kernel for CUDA
tensors and runs the plain twin from ``ops.atrous`` for CPU tensors, so the
sweeps compute one algorithm on either device, and counts its launches in
its ``launches`` attribute.  K1b's and K14's wrappers take ``precision``:
their bfloat16 forms (the TPU kernels' ``precision="bf16"``, one
``__nv_bfloat162`` pair of pixels a thread on the card; plain twins
``atrous_level_ref`` / ``atrous_level_bwd_ref`` with ``precision="bf16"``)
count on ``.bf16.launches`` instead.  The adjoints K14 and K2/K2b take
``staged``: on the card each runs a staged form (its centres' values
staged once a block in shared memory) or reads the centres through the
caches, by default as ``utils.tiling.adjoint_staged`` picks from the
staged tile's size; both forms give the same floats.  A staged launch past
radius 2 also counts on the wrapper's ``.wide.launches``.

Tiles: K1, K1b and K14 take ``tile=Tile(origin, bounds)`` (the sharded
sweep, ``parallel/sharded.py``): the colour/variance and normal/depth
planes are then canvases around the tile of ``zgrad`` (views into larger
canvases included), and a tap is dropped by its global coordinate, as
``atrous_level_fwd_canvas`` and ``atrous_level_tile`` do with their origin
and bounds; K2 and K14 take ``out_halo`` and then write the gradients of
the canvas margins too (``atrous_level_bwd_stored_canvas``'s margin-
writing form).  Without them every launch is the whole-frame one.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SVGFParams
from ..utils.timing import spanned
from ..utils.tiling import adjoint_staged
from .atrous import (PRECISIONS, WEIGHT_MATHS, _EPS, _LN2, _LOG2E,
                     _spline_taps, atrous_level_bwd_ref,
                     atrous_level_bwd_stored_ref, atrous_level_ref,
                     atrous_level_wgrad_bwd_ref, bf16_constants,
                     sigma_denominator)
from .common import Tile, canvas_margin, finite_diff_gradients
from .cuda import _build

BWD_IMPLS = ("stored", "stored_f32", "recompute", "none")


class _AtrousParams(ctypes.Structure):
    """Mirror of ``struct AtrousParams`` in ``ops/cuda/atrous.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "spacing", "radius", "fast", "luma_only")] + [
        (n, ctypes.c_float) for n in
        ("sigma_color", "sigma_depth", "sigma_normal",
         "sz2", "eps2", "c_s1", "c_s2")] + [("taps", ctypes.c_float * 5)]


class _AtrousTile(ctypes.Structure):
    """Mirror of ``struct AtrousTile`` in ``ops/cuda/atrous.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("Hg", "Wg", "gy0", "gx0", "d_rs", "d_ps", "d_m", "g_rs",
                 "g_ps", "g_m", "o_m")]


class _AtrousBf16(ctypes.Structure):
    """Mirror of ``struct AtrousBf16`` in ``ops/cuda/atrous_common.cuh``:
    the bf16 forms' constants (``ops.atrous.bf16_constants``), each a float
    that bfloat16 represents exactly."""

    _fields_ = [(n, ctypes.c_float) for n in
                ("l0", "l1", "l2", "ln2", "sixth", "floor", "sz2", "eps2",
                 "c_s1", "c_s2")]


def _bf16_params(params):
    return _AtrousBf16(**bf16_constants(params))


class LaunchCount:
    """The launch count of one form of a wrapper's kernel (``.launches``),
    kept apart from the wrapper's own."""

    def __init__(self):
        self.launches = 0


def _ref(struct):
    """A pointer argument: the struct's address, or NULL for None (the
    caller keeps the struct alive through the call)."""
    return None if struct is None else ctypes.addressof(struct)


# the largest radius whose 1-D taps ride in AtrousParams.taps
_STRUCT_RADIUS = 2
_wide_taps_cache = {}


def _wide_taps(radius, dev):
    """The device array of a radius's 2r+1 taps for the kernels' WIDE
    instantiation, or None (NULL) for a radius whose taps ride in
    ``AtrousParams``; one array a (radius, device), kept for reuse."""
    if radius <= _STRUCT_RADIUS:
        return None
    key = (radius, str(dev))
    if key not in _wide_taps_cache:
        _wide_taps_cache[key] = torch.tensor(_spline_taps(radius),
                                             dtype=torch.float32, device=dev)
    return _wide_taps_cache[key]


def _taps_ptr(radius, dev):
    taps = _wide_taps(radius, dev)
    return None if taps is None else taps.data_ptr()


def _launch_params(H, W, level, params, weight_math="exact"):
    r = params.radius
    struct_taps = _spline_taps(r) if r <= _STRUCT_RADIUS else ()
    return _AtrousParams(
        H=H, W=W, spacing=1 << level, radius=r,
        fast=int(weight_math == "fast"),
        luma_only=int(params.luma_only_from is not None
                      and level >= params.luma_only_from),
        sigma_color=params.sigma_color, sigma_depth=params.sigma_depth,
        sigma_normal=params.sigma_normal,
        sz2=params.sigma_depth * _LN2, eps2=_EPS * _LN2,
        c_s1=params.sigma_normal * _LOG2E * 0.5,
        c_s2=params.sigma_normal * _LOG2E * 0.125,
        taps=(ctypes.c_float * 5)(*struct_taps))


def _neighbourhood(dev, H, W, tile, color, variance, normal, depth, reach,
                   out_halo=0):
    """Pointers of the planes a level reads around a pixel (colour,
    variance, normal, depth; ``variance`` may be None) and the launch's
    ``_AtrousTile`` (None: the whole frame).  Whole frame: contiguous
    (…, H, W) planes.  Tile: two canvases, colour/variance and
    normal/depth, each with one margin and one row stride, the margins >=
    ``reach``."""
    if tile is None:
        if out_halo:
            raise ValueError("out_halo needs a tile")
        named = [(color, "color", 3), (variance, "variance", None),
                 (normal, "normal", 3), (depth, "depth", None)]
        return _planes(dev, H, W, [t for t in named if t[0] is not None]), \
            None
    md = canvas_margin(color, H, W, "color")
    mg = canvas_margin(normal, H, W, "normal")
    if min(md, mg) < reach:
        raise ValueError(f"canvas margins {md}, {mg} < the reach {reach}")
    ptrs = []
    for t, name, k, m, ref in ((color, "color", 3, md, color),
                               (variance, "variance", None, md, color),
                               (normal, "normal", 3, mg, normal),
                               (depth, "depth", None, mg, normal)):
        if t is None:
            continue
        shape = (H + 2 * m, W + 2 * m)
        ptrs.append(_build.check_canvas(t, name, shape if k is None
                                        else (k,) + shape, torch.float32,
                                        dev))
        if t.stride(-2) != ref.stride(-2):
            raise ValueError(f"{name}: row stride {t.stride(-2)}, expected "
                             f"{ref.stride(-2)} (one canvas geometry)")
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    return ptrs, _AtrousTile(
        Hg=Hg, Wg=Wg, gy0=gy0, gx0=gx0, d_rs=color.stride(1),
        d_ps=color.stride(0), d_m=md, g_rs=normal.stride(1),
        g_ps=normal.stride(0), g_m=mg, o_m=out_halo)


def _planes(dev, H, W, named):
    """Data pointers of ``(tensor, name, n_planes or None)`` triples, each
    checked to be a contiguous float32 (n_planes, H, W) or (H, W) tensor on
    ``dev``."""
    return [_build.check_input(t, n, (H, W) if k is None else (k, H, W),
                               torch.float32, dev) for t, n, k in named]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_sweep(color, params: SVGFParams, weight_math: str) -> None:
    if weight_math not in WEIGHT_MATHS:
        raise ValueError(f"unknown weight_math: {weight_math!r}")
    if params.pyramid_from is not None:
        raise NotImplementedError(
            "pyramid_from (half-res deep levels) is a plain-path experiment "
            "only — it FAILED the two-scene quality gate (−0.48/−0.60 dB) "
            "and was closed; unset it for the kernel path (the plain path, "
            "impl='plain', runs it)")


def _check_precision(precision, tile=None, out_halo=0):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "bf16" and (tile is not None or out_halo):
        raise ValueError("precision='bf16' is the whole-frame per-level "
                         "form: no tile or out_halo")


def zgrad_cuda(depth: torch.Tensor) -> torch.Tensor:
    """(2, H, W) depth gradient of the sweep (``finite_diff_gradients``);
    one small kernel on the card."""
    _build.check_no_grad("zgrad_cuda", depth)
    if not depth.is_cuda:
        return finite_diff_gradients(depth)
    H, W = depth.shape
    ptr = _build.check_input(depth, "depth", (H, W), torch.float32,
                             depth.device)
    zgrad = torch.empty((2, H, W), dtype=torch.float32, device=depth.device)
    _build.check(_build.kernels().rdt_zgrad(
        ptr, zgrad.data_ptr(), H, W, _stream(depth.device)), "rdt_zgrad")
    return zgrad


def bf16_bit_formulas_cuda(device) -> torch.Tensor:
    """The bf16 forms' bit tricks beside the formulas they replaced, on
    every bf16 pattern (``rdt_bf16_formulas``, card only): a (4, 65536)
    int32 tensor of packed lane pairs, the rows ``exp2_fast_bf16x2`` with
    2^i by conversion and clamp, the same from the bf16 bits, the
    reciprocal rounded from ``__frcp_rn`` and from ``rcp.approx.f32``;
    column j's low lane takes pattern j, its high lane (j·40503) mod 2^16.
    The constants are ``SVGFParams()``'s."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("bf16_bit_formulas_cuda probes the card's "
                         "arithmetic: a CUDA device only")
    out = torch.empty((4, 65536), dtype=torch.int32, device=device)
    b = _bf16_params(SVGFParams())
    _build.check(_build.kernels().rdt_bf16_formulas(
        out.data_ptr(), ctypes.addressof(b), _stream(device)),
        "rdt_bf16_formulas")
    return out


def _launch_level(color, variance, normal, depth, zgrad, sigma_denom, *,
                  level, params, weight_math, w_dtype, want_norm, tile):
    """One launch of the level kernel (K1 with ``sigma_denom`` None, else
    K1b); returns ``(c, v, w or None, N or None)``."""
    H, W = zgrad.shape[-2:]
    dev = color.device
    f32 = torch.float32
    reach = max(params.radius << level, int(sigma_denom is None))
    ptrs, t = _neighbourhood(dev, H, W, tile, color, variance, normal,
                             depth, reach)
    ptrs += _planes(dev, H, W, ((zgrad, "zgrad", 2),))
    sden_ptr = None
    if sigma_denom is not None:
        sden_ptr, = _planes(dev, H, W, ((sigma_denom, "sigma_denom", None),))
    c_out = torch.empty((3, H, W), dtype=f32, device=dev)
    v_out = torch.empty((H, W), dtype=f32, device=dev)
    w = norm = None
    if w_dtype is not None:
        if w_dtype not in (torch.bfloat16, f32):
            raise ValueError(f"weights: dtype {w_dtype}, expected bfloat16 "
                             f"or float32")
        w = torch.empty(((2 * params.radius + 1) ** 2, H, W), dtype=w_dtype,
                        device=dev)
    if want_norm:
        norm = torch.empty((H, W), dtype=f32, device=dev)
    p = _launch_params(H, W, level, params, weight_math)
    rc = _build.kernels().rdt_atrous_level(
        *ptrs, sden_ptr, c_out.data_ptr(), v_out.data_ptr(),
        None if w is None else w.data_ptr(),
        None if norm is None else norm.data_ptr(), int(w_dtype == f32),
        ctypes.addressof(p), _ref(t), _taps_ptr(params.radius, dev),
        _stream(dev))
    _build.check(rc, "rdt_atrous_level")
    return c_out, v_out, w, norm


def atrous_level_cuda(color, variance, normal, depth, zgrad, *, level: int,
                      params: SVGFParams, weight_math: str = "exact",
                      store: bool = False, store_dtype=torch.bfloat16,
                      tile: Tile = None):
    """One level forward (K1, σ-denominator fused).  Returns ``(c, v)``, and
    with ``store`` also the (n_taps, H, W) tap weights in ``store_dtype``
    (bf16 for ``bwd_impl="stored"``, float32 for ``"stored_f32"``) and the
    (H, W) normaliser N that the stored-weight adjoint reads.  No backward
    of its own (the sweeps below own the gradient): it raises if an input
    requires grad.  ``tile``: see the module docstring (the canvases'
    margins >= r·2^level).

    Each launch adds one to ``atrous_level_cuda.launches``."""
    _build.check_no_grad("atrous_level_cuda", color, variance, normal, depth)
    if not color.is_cuda:
        out = atrous_level_ref(color, variance, normal, depth, zgrad,
                               level=level, params=params,
                               weight_math=weight_math, return_weights=store,
                               tile=tile)
        if store:
            c, v, w, norm = out
            return c, v, w.to(store_dtype), norm
        return out
    c, v, w, norm = _launch_level(
        color, variance, normal, depth, zgrad, None, level=level,
        params=params, weight_math=weight_math,
        w_dtype=store_dtype if store else None, want_norm=store, tile=tile)
    atrous_level_cuda.launches += 1
    return (c, v, w, norm) if store else (c, v)


atrous_level_cuda.launches = 0


def _launch_level_bf16(color, variance, normal, depth, zgrad, sigma_denom,
                       *, level, params, save_weights, write_sigma):
    """One launch of K1b's bf16 form (``sigma_denom`` None: the σ-
    denominator fused, written to a plane with ``write_sigma``); returns
    ``(c, v, w or None, N, σ or None)``."""
    H, W = depth.shape
    dev = color.device
    f32 = torch.float32
    named = [(color, "color", 3), (variance, "variance", None),
             (normal, "normal", 3), (depth, "depth", None),
             (zgrad, "zgrad", 2)]
    if sigma_denom is not None:
        named.append((sigma_denom, "sigma_denom", None))
    ptrs = _planes(dev, H, W, named)
    sden_ptr = ptrs.pop() if sigma_denom is not None else None
    c_out = torch.empty((3, H, W), dtype=f32, device=dev)
    v_out = torch.empty((H, W), dtype=f32, device=dev)
    norm = torch.empty((H, W), dtype=f32, device=dev)
    w = (torch.empty(((2 * params.radius + 1) ** 2, H, W), dtype=f32,
                     device=dev) if save_weights else None)
    sden = (torch.empty((H, W), dtype=f32, device=dev) if write_sigma
            else None)
    p, b = _launch_params(H, W, level, params), _bf16_params(params)
    rc = _build.kernels().rdt_atrous_level_bf16(
        *ptrs, sden_ptr, None if sden is None else sden.data_ptr(),
        c_out.data_ptr(), v_out.data_ptr(),
        None if w is None else w.data_ptr(), norm.data_ptr(),
        ctypes.addressof(p), ctypes.addressof(b),
        _taps_ptr(params.radius, dev), _stream(dev))
    _build.check(rc, "rdt_atrous_level_bf16")
    return c_out, v_out, w, norm, sden


def atrous_level_fwd_cuda(color, variance, normal, depth, zgrad, sigma_denom,
                          *, level: int, params: SVGFParams,
                          save_weights: bool = False, tile: Tile = None,
                          precision: str = "f32",
                          return_sigma_denom: bool = False):
    """One level forward with a given σ-denominator (K1b, the counterpart of
    ``atrous_level_fwd_pallas``; exact weights).  Returns ``(c, v, N)``,
    and with ``save_weights`` also the (n_taps, H, W) float32 tap weights.
    Raises if an input requires grad (:func:`atrous_level` owns the
    gradient).  ``tile`` as in :func:`atrous_level_cuda`.

    ``precision="bf16"``: K1b's bfloat16 form on the whole frame (the
    planes rounded to bf16 as the kernel stages them, the tap math in
    bf16, float32 sums; ``atrous_level_ref(..., precision="bf16")``).
    With ``sigma_denom=None`` (bf16 only, no ``save_weights``) the kernel
    computes the σ-denominator itself from the variance (as K1 fuses it;
    the same floats as :func:`~.atrous.sigma_denominator`, which the CPU
    path computes and feeds the twin), and ``return_sigma_denom`` appends
    it, written by the kernel, to the outputs (K14's bf16 form reads it).

    Each float32 launch adds one to ``atrous_level_fwd_cuda.launches``,
    each bf16 launch to ``atrous_level_fwd_cuda.bf16.launches``, and each
    bf16 launch with the σ-denominator fused also to
    ``atrous_level_fwd_cuda.bf16_fused.launches``."""
    _check_precision(precision, tile)
    fused = sigma_denom is None
    if fused and (precision != "bf16" or save_weights):
        raise ValueError("sigma_denom=None (the fused σ-denominator) is "
                         "K1b's bf16 form without save_weights")
    if return_sigma_denom and not fused:
        raise ValueError("return_sigma_denom needs sigma_denom=None")
    _build.check_no_grad("atrous_level_fwd_cuda", color, variance, normal,
                         depth, zgrad, sigma_denom)
    if not color.is_cuda:
        sd = sigma_denominator(variance, params) if fused else sigma_denom
        c, v, w, norm = atrous_level_ref(
            color, variance, normal, depth, zgrad, level=level,
            params=params, sigma_denom=sd, return_weights=True,
            tile=tile, precision=precision)
        out = (c, v, norm, w) if save_weights else (c, v, norm)
        return out + (sd,) if return_sigma_denom else out
    if precision == "bf16":
        c, v, w, norm, sd = _launch_level_bf16(
            color, variance, normal, depth, zgrad, sigma_denom, level=level,
            params=params, save_weights=save_weights,
            write_sigma=return_sigma_denom)
        atrous_level_fwd_cuda.bf16.launches += 1
        if fused:
            atrous_level_fwd_cuda.bf16_fused.launches += 1
    else:
        c, v, w, norm = _launch_level(
            color, variance, normal, depth, zgrad, sigma_denom, level=level,
            params=params, weight_math="exact",
            w_dtype=torch.float32 if save_weights else None, want_norm=True,
            tile=tile)
        atrous_level_fwd_cuda.launches += 1
    out = (c, v, norm, w) if save_weights else (c, v, norm)
    return out + (sd,) if return_sigma_denom else out


atrous_level_fwd_cuda.launches = 0
atrous_level_fwd_cuda.bf16 = LaunchCount()
atrous_level_fwd_cuda.bf16_fused = LaunchCount()


def _out_region(H, W, out_halo, dev):
    """Uninitialised output planes (3, …) and (…) of the centre-plus-halo
    region an adjoint writes (every element is written)."""
    shape = (H + 2 * out_halo, W + 2 * out_halo)
    return (torch.empty((3,) + shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))


def _launch_bwd_stored(w, norm, gc, gv, level, radius, out_halo, staged):
    H, W = gv.shape
    dev = gc.device
    ptrs = [_build.check_input(w, "w", ((2 * radius + 1) ** 2, H, W),
                               w.dtype, dev)] + _planes(dev, H, W, (
        (norm, "norm", None), (gc, "gc", 3), (gv, "gv", None)))
    dc, dv = _out_region(H, W, out_halo, dev)
    # the margin-writing form is a tile launch; its other fields are unused
    t = _AtrousTile(o_m=out_halo) if out_halo else None
    rc = _build.kernels().rdt_atrous_bwd_stored(
        *ptrs, dc.data_ptr(), dv.data_ptr(), H, W, 1 << level, radius,
        int(w.dtype == torch.float32), _ref(t), int(staged), _stream(dev))
    _build.check(rc, "rdt_atrous_bwd_stored")
    return dc, dv


def _count_form(wrapper, radius, staged):
    """Count a launch of ``wrapper``'s kernel, and on its ``.wide`` too
    where it ran the staged form past radius 2."""
    wrapper.launches += 1
    if staged and radius > _STRUCT_RADIUS:
        wrapper.wide.launches += 1


def atrous_level_bwd_stored_cuda(w, norm, gc, gv, *, level: int,
                                 radius: int, out_halo: int = 0,
                                 staged: bool = None):
    """One level of the stored-weight adjoint; returns ``(d_color,
    d_variance)`` as ``atrous_level_bwd_stored_ref`` does.  bf16 weights
    go to K2 (``atrous_level_bwd_stored_canvas``), float32 weights to K2b
    (:func:`atrous_level_bwd_stored_f32_cuda`).  ``out_halo`` = o: the
    gradients of the (H + 2o, W + 2o) canvas around the tile (the margin-
    writing form of the sharded sweep).  ``staged``: the kernel's form on
    the card, None the tiling model's choice
    (``utils.tiling.adjoint_staged``), True staged, False the centres
    through the caches; every form gives the same floats, and the CPU runs
    the twin whatever it says.

    Each K2 launch adds one to ``atrous_level_bwd_stored_cuda.launches``,
    and a staged launch past radius 2 also to
    ``atrous_level_bwd_stored_cuda.wide.launches``."""
    if w.dtype == torch.float32:
        return atrous_level_bwd_stored_f32_cuda(w, norm, gc, gv, level=level,
                                                radius=radius,
                                                out_halo=out_halo,
                                                staged=staged)
    _build.check_no_grad("atrous_level_bwd_stored_cuda", w, norm, gc, gv)
    staged = adjoint_staged("K2", radius, level, staged)
    if not gc.is_cuda:
        return atrous_level_bwd_stored_ref(w, norm, gc, gv, level=level,
                                           radius=radius, out_halo=out_halo)
    if w.dtype != torch.bfloat16:
        raise ValueError(f"w: dtype {w.dtype}, expected bfloat16 or float32")
    out = _launch_bwd_stored(w, norm, gc, gv, level, radius, out_halo,
                             staged)
    _count_form(atrous_level_bwd_stored_cuda, radius, staged)
    return out


atrous_level_bwd_stored_cuda.launches = 0
atrous_level_bwd_stored_cuda.wide = LaunchCount()


def atrous_level_bwd_stored_f32_cuda(w, norm, gc, gv, *, level: int,
                                     radius: int, out_halo: int = 0,
                                     staged: bool = None):
    """K2b, the stored-weight adjoint from float32 weights (the counterpart
    of ``atrous_level_bwd_stored_pallas``; the ``bwd_impl="stored_f32"``
    backward); returns ``(d_color, d_variance)``.  ``staged`` as in
    :func:`atrous_level_bwd_stored_cuda`.

    Each launch adds one to ``atrous_level_bwd_stored_f32_cuda.launches``,
    and a staged launch past radius 2 also to its ``.wide.launches``."""
    _build.check_no_grad("atrous_level_bwd_stored_f32_cuda", w, norm, gc, gv)
    staged = adjoint_staged("K2", radius, level, staged)
    if not gc.is_cuda:
        return atrous_level_bwd_stored_ref(w, norm, gc, gv, level=level,
                                           radius=radius, out_halo=out_halo)
    if w.dtype != torch.float32:
        raise ValueError(f"w: dtype {w.dtype}, expected float32")
    out = _launch_bwd_stored(w, norm, gc, gv, level, radius, out_halo,
                             staged)
    _count_form(atrous_level_bwd_stored_f32_cuda, radius, staged)
    return out


atrous_level_bwd_stored_f32_cuda.launches = 0
atrous_level_bwd_stored_f32_cuda.wide = LaunchCount()


def atrous_level_bwd_cuda(color, normal, depth, zgrad, sigma_denom, norm,
                          g_color, g_var, *, level: int, params: SVGFParams,
                          tile: Tile = None, out_halo: int = 0,
                          precision: str = "f32", staged: bool = None):
    """K14, the recompute adjoint of one level (the counterpart of
    ``atrous_level_bwd_pallas``): the weights are re-derived from the
    forward's inputs and its σ-denominator by the forward's exact weight
    math.  Returns ``(d_color, d_variance)``.  ``tile`` as in
    :func:`atrous_level_cuda` (canvas margins >= ``out_halo``),
    ``out_halo`` and ``staged`` (the float32 form's) as in
    :func:`atrous_level_bwd_stored_cuda`.

    ``precision="bf16"``: K14's bfloat16 form on the whole frame, the
    adjoint of K1b's (``atrous_level_bwd_ref(..., precision="bf16")``).

    Each float32 launch adds one to ``atrous_level_bwd_cuda.launches`` (a
    staged one past radius 2 also to ``atrous_level_bwd_cuda.wide.
    launches``), each bf16 launch to
    ``atrous_level_bwd_cuda.bf16.launches``."""
    _check_precision(precision, tile, out_halo)
    _build.check_no_grad("atrous_level_bwd_cuda", color, normal, depth, zgrad,
                         sigma_denom, norm, g_color, g_var)
    if precision == "bf16" and staged is not None:
        raise ValueError("staged chooses the float32 form's staging")
    staged = adjoint_staged("K14", params.radius, level, staged)
    if not g_color.is_cuda:
        return atrous_level_bwd_ref(color, normal, depth, zgrad, sigma_denom,
                                    norm, g_color, g_var, level=level,
                                    params=params, tile=tile,
                                    out_halo=out_halo, precision=precision)
    H, W = zgrad.shape[-2:]
    dev = g_color.device
    if precision == "bf16":
        ptrs = _planes(dev, H, W, (
            (color, "color", 3), (normal, "normal", 3),
            (depth, "depth", None), (zgrad, "zgrad", 2),
            (sigma_denom, "sigma_denom", None), (norm, "norm", None),
            (g_color, "g_color", 3), (g_var, "g_var", None)))
        dc, dv = _out_region(H, W, 0, dev)
        p, b = _launch_params(H, W, level, params), _bf16_params(params)
        rc = _build.kernels().rdt_atrous_bwd_bf16(
            *ptrs, dc.data_ptr(), dv.data_ptr(), ctypes.addressof(p),
            ctypes.addressof(b), _taps_ptr(params.radius, dev), _stream(dev))
        _build.check(rc, "rdt_atrous_bwd_bf16")
        atrous_level_bwd_cuda.bf16.launches += 1
        return dc, dv
    ptrs, t = _neighbourhood(dev, H, W, tile, color, None, normal, depth,
                             out_halo, out_halo)
    ptrs += _planes(dev, H, W, (
        (zgrad, "zgrad", 2), (sigma_denom, "sigma_denom", None),
        (norm, "norm", None), (g_color, "g_color", 3),
        (g_var, "g_var", None)))
    dc, dv = _out_region(H, W, out_halo, dev)
    p = _launch_params(H, W, level, params)
    rc = _build.kernels().rdt_atrous_bwd(
        *ptrs, dc.data_ptr(), dv.data_ptr(), ctypes.addressof(p), _ref(t),
        _taps_ptr(params.radius, dev), int(staged), _stream(dev))
    _build.check(rc, "rdt_atrous_bwd")
    _count_form(atrous_level_bwd_cuda, params.radius, staged)
    return dc, dv


atrous_level_bwd_cuda.launches = 0
atrous_level_bwd_cuda.wide = LaunchCount()
atrous_level_bwd_cuda.bf16 = LaunchCount()


def atrous_level_wgrad_bwd_cuda(color, variance, normal, depth, zgrad,
                                sigma_denom, out_c, out_v, norm, g_color,
                                g_var, *, level: int, params: SVGFParams):
    """K9, the full adjoint of one level through its weights (the
    counterpart of ``atrous_level_wgrad_bwd_pallas``): one kernel, the
    centre and neighbour terms of each pixel.  Returns ``(d_color,
    d_variance, d_normal, d_depth, d_zgrad, d_sigma_denom)`` as
    ``atrous_level_wgrad_bwd_ref`` does.

    Each launch adds one to ``atrous_level_wgrad_bwd_cuda.launches``."""
    ins = (color, variance, normal, depth, zgrad, sigma_denom, out_c, out_v,
           norm, g_color, g_var)
    _build.check_no_grad("atrous_level_wgrad_bwd_cuda", *ins)
    if not g_color.is_cuda:
        return atrous_level_wgrad_bwd_ref(*ins, level=level, params=params)
    H, W = depth.shape
    dev = g_color.device
    names = ("color", "variance", "normal", "depth", "zgrad", "sigma_denom",
             "out_c", "out_v", "norm", "g_color", "g_var")
    planes = (3, None, 3, None, 2, None, 3, None, None, 3, None)
    ptrs = _planes(dev, H, W, zip(ins, names, planes))
    outs = tuple(torch.empty((H, W) if k is None else (k, H, W),
                             dtype=torch.float32, device=dev)
                 for k in (3, None, 3, None, 2, None))
    p = _launch_params(H, W, level, params)
    rc = _build.kernels().rdt_atrous_wgrad_bwd(
        *ptrs, *(t.data_ptr() for t in outs), ctypes.addressof(p),
        _taps_ptr(params.radius, dev), _stream(dev))
    _build.check(rc, "rdt_atrous_wgrad_bwd")
    atrous_level_wgrad_bwd_cuda.launches += 1
    return outs


atrous_level_wgrad_bwd_cuda.launches = 0


class _AtrousLevel(torch.autograd.Function):
    """One level with a given σ-denominator and its hand-written adjoint
    (the JAX custom-VJP ``atrous_level``): K1b forward (in ``precision``);
    K9 backward with ``weight_grads`` (float32, whatever the forward's
    precision, as ``_atrous_bwd`` does), else K14 (in ``precision``) and
    zero gradients for the normal, depth, ∇z and σ-denominator.  A σ of
    None (bf16, no ``weight_grads``) is fused into the forward, which
    writes it for K14 when an input requires grad."""

    @staticmethod
    def forward(ctx, color, variance, normal, depth, zgrad, sigma_denom,
                level, params, weight_grads, precision):
        fused = sigma_denom is None
        write = fused and any(ctx.needs_input_grad)
        out = atrous_level_fwd_cuda(color, variance, normal, depth, zgrad,
                                    sigma_denom, level=level, params=params,
                                    precision=precision,
                                    return_sigma_denom=write)
        c, v, norm = out[:3]
        sden = out[3] if write else sigma_denom
        ctx.level, ctx.params, ctx.weight_grads = level, params, weight_grads
        ctx.precision = precision
        if weight_grads:
            ctx.save_for_backward(color, variance, normal, depth, zgrad,
                                  sden, c, v, norm)
        else:
            ctx.save_for_backward(color, normal, depth, zgrad, sden, norm)
        return c, v

    @staticmethod
    @spanned("rdt.atrous.bwd")
    def backward(ctx, gc, gv):
        kw = dict(level=ctx.level, params=ctx.params)
        gc, gv = gc.contiguous(), gv.contiguous()
        if ctx.weight_grads:
            grads = atrous_level_wgrad_bwd_cuda(*ctx.saved_tensors, gc, gv,
                                                **kw)
        else:
            color, normal, depth, zgrad, sden, norm = ctx.saved_tensors
            dc, dv = atrous_level_bwd_cuda(color, normal, depth, zgrad, sden,
                                           norm, gc, gv,
                                           precision=ctx.precision, **kw)
            need = ctx.needs_input_grad
            grads = (dc, dv) + tuple(
                torch.zeros_like(t) if need[k] else None
                for k, t in zip(range(2, 6), (normal, depth, zgrad, sden)))
        return grads + (None, None, None, None)


def atrous_level(color, variance, normal, depth, zgrad, sigma_denom, level,
                 params, weight_grads: bool = False, precision: str = "f32"):
    """One differentiable level, ``(c, v)``: K1b forward, K14 or (with
    ``weight_grads``) K9 backward; ``precision="bf16"``: their bf16 forms
    (K9 stays float32), and ``sigma_denom=None`` fuses the σ-denominator
    into K1b-bf16 (no ``weight_grads``)."""
    if sigma_denom is None and weight_grads:
        raise ValueError("weight_grads needs the σ-denominator tensor")
    return _AtrousLevel.apply(color, variance, normal, depth, zgrad,
                              sigma_denom, level, params, weight_grads,
                              precision)


def _sweep_forward(color, variance, normal, depth, params, weight_math,
                   store_dtype):
    """K1 over all levels, storing weights in ``store_dtype`` (None: no
    store); returns ``(c, v, feedback, per-level (w, N))``."""
    zgrad = zgrad_cuda(depth)
    c, v = color, variance
    feedback = color
    saved = []
    store = store_dtype is not None
    for lvl in range(params.iterations):
        out = atrous_level_cuda(c, v, normal, depth, zgrad, level=lvl,
                                params=params, weight_math=weight_math,
                                store=store, store_dtype=store_dtype)
        c, v = out[:2]
        if store:
            saved.append(out[2:])
        if lvl + 1 == params.feedback_level:
            feedback = c
    return c, v, feedback, saved


def svgf_spatial_cuda(color: torch.Tensor, variance: torch.Tensor,
                      normal: torch.Tensor, depth: torch.Tensor, *,
                      params: SVGFParams = SVGFParams(),
                      weight_math: str = "exact",
                      return_feedback: bool = False):
    """Multi-level à-trous sweep for inference.  Returns ``(c, v)`` or,
    with ``return_feedback``, ``(c, v, feedback)`` as ``svgf_spatial_ref``
    does.  Raises if an input requires grad: the differentiable sweeps are
    :func:`svgf_spatial_stored_cuda` and :func:`svgf_spatial_ad_cuda`."""
    _check_sweep(color, params, weight_math)
    _build.check_no_grad("svgf_spatial_cuda", color, variance, normal, depth)
    c, v, feedback, _ = _sweep_forward(color, variance, normal, depth,
                                       params, weight_math, None)
    return (c, v, feedback) if return_feedback else (c, v)


class _StoredSweep(torch.autograd.Function):
    """The chained sweep with the stored-weight adjoint (``_svgf_chained``
    with ``bwd_impl="stored"`` or ``"stored_f32"``): detached-weight
    semantics, gradients reach colour and variance; normal and depth get
    zero."""

    @staticmethod
    def forward(ctx, color, variance, normal, depth, params, weight_math,
                store_dtype):
        store = any(ctx.needs_input_grad[:2])
        c, v, feedback, saved = _sweep_forward(
            color, variance, normal, depth, params, weight_math,
            store_dtype if store else None)
        ctx.params = params
        ctx.saved_levels = saved
        # an output that aliases another output or an input gets its own
        # tensor, so autograd sees three distinct outputs
        if feedback is c or feedback is color:
            feedback = feedback.clone()
        return c, v, feedback

    @staticmethod
    @spanned("rdt.atrous.bwd")
    def backward(ctx, gc, gv, gfeed):
        params = ctx.params
        feed_used = 1 <= params.feedback_level <= params.iterations
        for lvl in reversed(range(params.iterations)):
            if feed_used and lvl + 1 == params.feedback_level:
                gc = gc + gfeed
            w, norm = ctx.saved_levels[lvl]
            gc, gv = atrous_level_bwd_stored_cuda(
                w, norm, gc.contiguous(), gv.contiguous(), level=lvl,
                radius=params.radius)
        if not feed_used:
            gc = gc + gfeed
        return gc, gv, None, None, None, None, None


def svgf_spatial_stored_cuda(color: torch.Tensor, variance: torch.Tensor,
                             normal: torch.Tensor, depth: torch.Tensor, *,
                             params: SVGFParams = SVGFParams(),
                             weight_math: str = "exact",
                             return_feedback: bool = False):
    """Differentiable multi-level sweep (the training forward): K1 in store
    mode when colour or variance requires grad, K2 in the backward.
    Returns ``(c, v)`` or ``(c, v, feedback)``.  The gradients carry the
    bf16 rounding of the stored weights (≤ 2^-8 relative per weight)."""
    return svgf_spatial_ad_cuda(color, variance, normal, depth, params=params,
                                weight_math=weight_math,
                                return_feedback=return_feedback,
                                bwd_impl="stored")


def svgf_spatial_ad_cuda(color: torch.Tensor, variance: torch.Tensor,
                         normal: torch.Tensor, depth: torch.Tensor, *,
                         params: SVGFParams = SVGFParams(),
                         return_feedback: bool = False,
                         precision: str = "f32", weight_grads: bool = False,
                         chained: bool = True, bwd_impl: str = "stored",
                         weight_math: str = "exact"):
    """The multi-level sweep with ``svgf_spatial_pallas``'s keyword surface
    and validation; returns ``(c, v)`` or ``(c, v, feedback)``.

    * ``chained=True`` (and no ``weight_grads``): ``bwd_impl="stored"`` and
      ``"stored_f32"`` run K1 with its fused σ-denominator, storing each
      level's weights (bf16, or float32) and N, and K2 (or K2b) in the
      backward; ``"none"`` is :func:`svgf_spatial_cuda` (no gradient).
    * ``bwd_impl="recompute"``, or ``chained=False``: per level, the
      σ-denominator of the detached variance in PyTorch, K1b with it, and
      K14 in the backward, which re-derives the weights from the same
      σ tensor.  ``chained=True`` and ``chained=False`` are this one code
      path here: the JAX package holds its two bit-equal in recompute mode
      (``tests/test_atrous_pallas.py``), and its per-level path always
      recomputes, whatever ``bwd_impl`` says.
    * ``weight_grads=True``: the full adjoint (``detach_weights=False``
      semantics): per level, K1b and then K9; ∇z (``finite_diff_gradients``)
      and the σ-denominator of the undetached variance are PyTorch
      operations under autograd, so K9's d_zgrad and d_sigma reach the
      depth and the variance as XLA chains them in JAX.
    * ``precision="bf16"``: the per-level path above, through the bfloat16
      forms of K1b and K14 (K9 with ``weight_grads``, as in JAX), whatever
      ``chained`` and ``bwd_impl`` say: JAX's chained path is float32 only.
      Without ``weight_grads`` each level is one K1b-bf16 launch with the
      σ-denominator fused (it writes σ for K14-bf16 when an input requires
      grad) and ∇z comes from :func:`zgrad_cuda`: no PyTorch glue a level
      on the card (on the CPU the plain twin is fed
      :func:`~.atrous.sigma_denominator`).  With ``weight_grads`` σ is
      the PyTorch :func:`~.atrous.sigma_denominator` as above.

    ``weight_math="fast"`` is taken on the chained f32 stored and
    ``"none"`` paths only, ``luma_only_from`` on the chained f32 stored and
    ``"none"`` paths only, as in JAX; ``pyramid_from`` raises (the plain
    sweep runs it, as JAX's jnp oracle does)."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl: {bwd_impl!r}")
    _check_sweep(color, params, weight_math)
    if weight_math == "fast" and bwd_impl == "recompute":
        raise ValueError("weight_math='fast' requires a stored bwd_impl")
    _check_precision(precision)
    if params.luma_only_from is not None and (
            bwd_impl == "recompute" or not chained or weight_grads
            or precision != "f32"):
        raise ValueError("luma_only_from requires the chained f32 "
                         "detached path with a stored or 'none' bwd_impl")
    on_chained = (chained and not weight_grads and precision == "f32"
                  and params.iterations > 0)
    if weight_math == "fast" and not on_chained:
        raise ValueError("weight_math='fast' is implemented on the chained "
                         "f32 detached path only")
    if on_chained and bwd_impl != "recompute":
        if bwd_impl == "none":
            return svgf_spatial_cuda(color, variance, normal, depth,
                                     params=params, weight_math=weight_math,
                                     return_feedback=return_feedback)
        store_dtype = (torch.float32 if bwd_impl == "stored_f32"
                       else torch.bfloat16)
        c, v, feedback = _StoredSweep.apply(color, variance, normal, depth,
                                            params, weight_math, store_dtype)
        return (c, v, feedback) if return_feedback else (c, v)

    # bf16: σ fused into each K1b-bf16 launch, ∇z one kernel (its gradient
    # is zero off the weight_grads path)
    fused = precision == "bf16" and not weight_grads
    zgrad = (zgrad_cuda(depth.detach()) if fused
             else finite_diff_gradients(depth))
    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        sden = (None if fused else
                sigma_denominator(v if weight_grads else v.detach(), params))
        c, v = atrous_level(c, v, normal, depth, zgrad, sden, lvl, params,
                            weight_grads, precision)
        if lvl + 1 == params.feedback_level:
            feedback = c
    return (c, v, feedback) if return_feedback else (c, v)
