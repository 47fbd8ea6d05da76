"""K1/K2 wrappers: the à-trous SVGF sweep through the CUDA level kernels.

Counterpart of ``svgf_spatial_pallas`` in
``raymarchdenoisercuda_tpu/ops/pallas/atrous_tpu.py`` on its chained path:

* :func:`svgf_spatial_cuda` is ``bwd_impl="none"``, the inference sweep (K1
  without weight writes; no gradient: it raises on an input that requires
  grad);
* :func:`svgf_spatial_stored_cuda` is ``bwd_impl="stored"``, the
  ``torch.autograd.Function`` counterpart of ``_svgf_chained``: K1 in store
  mode keeps each level's bf16 tap weights and N, and the backward runs K2
  level by level in reverse.

The per-level wrappers :func:`atrous_level_cuda` (K1) and
:func:`atrous_level_bwd_stored_cuda` (K2) launch their kernel for CUDA
tensors and run the plain twin from ``ops.atrous`` for CPU tensors, so both
sweeps compute one algorithm on either device.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SVGFParams
from .atrous import (WEIGHT_MATHS, _EPS, _LN2, _LOG2E, _spline_taps,
                     atrous_level_bwd_stored_ref, atrous_level_ref)
from .common import finite_diff_gradients
from .cuda import _build


class _AtrousParams(ctypes.Structure):
    """Mirror of ``struct AtrousParams`` in ``ops/cuda/atrous.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "spacing", "radius", "fast", "luma_only")] + [
        (n, ctypes.c_float) for n in
        ("sigma_color", "sigma_depth", "sigma_normal",
         "sz2", "eps2", "c_s1", "c_s2")] + [("taps", ctypes.c_float * 5)]


def _check_sweep(color, params: SVGFParams, weight_math: str) -> None:
    if weight_math not in WEIGHT_MATHS:
        raise ValueError(f"unknown weight_math: {weight_math!r}")
    if params.pyramid_from is not None:
        raise NotImplementedError("pyramid_from (half-resolution deep levels) "
                                  "is not ported")
    if color.is_cuda and params.radius not in (1, 2):
        raise ValueError(f"the CUDA level kernel takes radius 1 or 2, "
                         f"got {params.radius}")


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
        ptr, zgrad.data_ptr(), H, W,
        torch.cuda.current_stream(depth.device).cuda_stream), "rdt_zgrad")
    return zgrad


def atrous_level_cuda(color, variance, normal, depth, zgrad, *, level: int,
                      params: SVGFParams, weight_math: str = "exact",
                      store: bool = False):
    """One level forward (K1).  Returns ``(c, v)``, and with ``store`` also
    the (n_taps, H, W) bf16 tap weights and the (H, W) normaliser N that
    the stored-weight adjoint reads.  No backward of its own (the sweeps
    below own the gradient): it raises if an input requires grad.

    Each launch adds one to ``atrous_level_cuda.launches``."""
    _build.check_no_grad("atrous_level_cuda", color, variance, normal, depth)
    if not color.is_cuda:
        out = atrous_level_ref(color, variance, normal, depth, zgrad,
                               level=level, params=params,
                               weight_math=weight_math, return_weights=store)
        if store:
            c, v, w, norm = out
            return c, v, w.to(torch.bfloat16), norm
        return out
    H, W = depth.shape
    dev = color.device
    f32 = torch.float32
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (color, "color", (3, H, W)), (variance, "variance", (H, W)),
        (normal, "normal", (3, H, W)), (depth, "depth", (H, W)),
        (zgrad, "zgrad", (2, H, W)))]
    r = params.radius
    p = _AtrousParams(
        H=H, W=W, spacing=1 << level, radius=r,
        fast=int(weight_math == "fast"),
        luma_only=int(params.luma_only_from is not None
                      and level >= params.luma_only_from),
        sigma_color=params.sigma_color, sigma_depth=params.sigma_depth,
        sigma_normal=params.sigma_normal,
        sz2=params.sigma_depth * _LN2, eps2=_EPS * _LN2,
        c_s1=params.sigma_normal * _LOG2E * 0.5,
        c_s2=params.sigma_normal * _LOG2E * 0.125,
        taps=(ctypes.c_float * 5)(*_spline_taps(r)))
    c_out = torch.empty((3, H, W), dtype=f32, device=dev)
    v_out = torch.empty((H, W), dtype=f32, device=dev)
    w = norm = None
    if store:
        w = torch.empty(((2 * r + 1) ** 2, H, W), dtype=torch.bfloat16,
                        device=dev)
        norm = torch.empty((H, W), dtype=f32, device=dev)
    rc = _build.kernels().rdt_atrous_level(
        *ptrs, c_out.data_ptr(), v_out.data_ptr(),
        w.data_ptr() if store else None, norm.data_ptr() if store else None,
        ctypes.addressof(p), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_atrous_level")
    atrous_level_cuda.launches += 1
    return (c_out, v_out, w, norm) if store else (c_out, v_out)


atrous_level_cuda.launches = 0


def atrous_level_bwd_stored_cuda(w, norm, gc, gv, *, level: int,
                                 radius: int):
    """One level of the stored-weight adjoint (K2); returns
    ``(d_color, d_variance)`` as ``atrous_level_bwd_stored_ref`` does.

    Each launch adds one to ``atrous_level_bwd_stored_cuda.launches``."""
    _build.check_no_grad("atrous_level_bwd_stored_cuda", w, norm, gc, gv)
    if not gc.is_cuda:
        return atrous_level_bwd_stored_ref(w, norm, gc, gv, level=level,
                                           radius=radius)
    H, W = gv.shape
    dev = gc.device
    f32 = torch.float32
    ptrs = [_build.check_input(w, "w", ((2 * radius + 1) ** 2, H, W),
                               torch.bfloat16, dev)] + [
        _build.check_input(t, n, s, f32, dev) for t, n, s in (
            (norm, "norm", (H, W)), (gc, "gc", (3, H, W)),
            (gv, "gv", (H, W)))]
    dc = torch.empty((3, H, W), dtype=f32, device=dev)
    dv = torch.empty((H, W), dtype=f32, device=dev)
    rc = _build.kernels().rdt_atrous_bwd_stored(
        *ptrs, dc.data_ptr(), dv.data_ptr(), H, W, 1 << level, radius,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_atrous_bwd_stored")
    atrous_level_bwd_stored_cuda.launches += 1
    return dc, dv


atrous_level_bwd_stored_cuda.launches = 0


def _sweep_forward(color, variance, normal, depth, params, weight_math,
                   store):
    """K1 over all levels; returns ``(c, v, feedback, per-level (w, N))``."""
    zgrad = zgrad_cuda(depth)
    c, v = color, variance
    feedback = color
    saved = []
    for lvl in range(params.iterations):
        out = atrous_level_cuda(c, v, normal, depth, zgrad, level=lvl,
                                params=params, weight_math=weight_math,
                                store=store)
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
    does.  Raises if an input requires grad: the differentiable sweep is
    :func:`svgf_spatial_stored_cuda`."""
    _check_sweep(color, params, weight_math)
    _build.check_no_grad("svgf_spatial_cuda", color, variance, normal, depth)
    c, v, feedback, _ = _sweep_forward(color, variance, normal, depth,
                                       params, weight_math, store=False)
    return (c, v, feedback) if return_feedback else (c, v)


class _StoredSweep(torch.autograd.Function):
    """The chained sweep with the stored-weight adjoint (``_svgf_chained``
    with ``bwd_impl="stored"``): detached-weight semantics, gradients reach
    colour and variance; normal and depth get zero."""

    @staticmethod
    def forward(ctx, color, variance, normal, depth, params, weight_math):
        store = any(ctx.needs_input_grad[:2])
        c, v, feedback, saved = _sweep_forward(
            color, variance, normal, depth, params, weight_math, store)
        ctx.params = params
        ctx.saved_levels = saved
        # an output that aliases another output or an input gets its own
        # tensor, so autograd sees three distinct outputs
        if feedback is c or feedback is color:
            feedback = feedback.clone()
        return c, v, feedback

    @staticmethod
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
        return gc, gv, None, None, None, None


def svgf_spatial_stored_cuda(color: torch.Tensor, variance: torch.Tensor,
                             normal: torch.Tensor, depth: torch.Tensor, *,
                             params: SVGFParams = SVGFParams(),
                             weight_math: str = "exact",
                             return_feedback: bool = False):
    """Differentiable multi-level sweep (the training forward): K1 in store
    mode when colour or variance requires grad, K2 in the backward.
    Returns ``(c, v)`` or ``(c, v, feedback)``.  The gradients carry the
    bf16 rounding of the stored weights (≤ 2^-8 relative per weight)."""
    _check_sweep(color, params, weight_math)
    c, v, feedback = _StoredSweep.apply(color, variance, normal, depth,
                                        params, weight_math)
    return (c, v, feedback) if return_feedback else (c, v)
