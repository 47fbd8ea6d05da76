"""K1 wrapper: the à-trous SVGF sweep through the CUDA level kernel.

Counterpart of ``svgf_spatial_pallas(..., bwd_impl="none")`` in
``raymarchdenoisercuda_tpu/ops/pallas/atrous_tpu.py``.  CUDA tensors run
``ops/cuda/atrous.cu`` (one launch per level, plus one for the depth
gradient); CPU tensors run the plain version ``ops.atrous.svgf_spatial_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SVGFParams
from .atrous import (WEIGHT_MATHS, _EPS, _LN2, _LOG2E, _spline_taps,
                     svgf_spatial_ref)
from .cuda import _build


class _AtrousParams(ctypes.Structure):
    """Mirror of ``struct AtrousParams`` in ``ops/cuda/atrous.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "spacing", "radius", "fast", "luma_only")] + [
        (n, ctypes.c_float) for n in
        ("sigma_color", "sigma_depth", "sigma_normal",
         "sz2", "eps2", "c_s1", "c_s2")] + [("taps", ctypes.c_float * 5)]


def svgf_spatial_cuda(color: torch.Tensor, variance: torch.Tensor,
                      normal: torch.Tensor, depth: torch.Tensor, *,
                      params: SVGFParams = SVGFParams(),
                      weight_math: str = "exact",
                      return_feedback: bool = False):
    """Multi-level à-trous sweep (inference).  Returns ``(c, v)`` or, with
    ``return_feedback``, ``(c, v, feedback)`` as ``svgf_spatial_ref`` does.

    Each level launch adds one to ``svgf_spatial_cuda.launches``."""
    if weight_math not in WEIGHT_MATHS:
        raise ValueError(f"unknown weight_math: {weight_math!r}")
    if not color.is_cuda:
        return svgf_spatial_ref(color, variance, normal, depth, params=params,
                                return_feedback=return_feedback,
                                weight_math=weight_math)
    if params.pyramid_from is not None:
        raise NotImplementedError("pyramid_from is not ported")
    if params.radius not in (1, 2):
        raise ValueError(f"the CUDA level kernel takes radius 1 or 2, "
                         f"got {params.radius}")
    H, W = depth.shape
    dev = color.device
    f32 = torch.float32
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (color, "color", (3, H, W)), (variance, "variance", (H, W)),
        (normal, "normal", (3, H, W)), (depth, "depth", (H, W)))]
    lib = _build.kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream

    zgrad = torch.empty((2, H, W), dtype=f32, device=dev)
    _build.check(lib.rdt_zgrad(ptrs[3], zgrad.data_ptr(), H, W, stream),
                 "rdt_zgrad")

    taps = _spline_taps(params.radius)
    p = _AtrousParams(
        H=H, W=W, spacing=1, radius=params.radius,
        fast=int(weight_math == "fast"), luma_only=0,
        sigma_color=params.sigma_color, sigma_depth=params.sigma_depth,
        sigma_normal=params.sigma_normal,
        sz2=params.sigma_depth * _LN2, eps2=_EPS * _LN2,
        c_s1=params.sigma_normal * _LOG2E * 0.5,
        c_s2=params.sigma_normal * _LOG2E * 0.125,
        taps=(ctypes.c_float * 5)(*taps))

    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        c_out = torch.empty_like(color)
        v_out = torch.empty_like(variance)
        p.spacing = 1 << lvl
        p.luma_only = int(params.luma_only_from is not None
                          and lvl >= params.luma_only_from)
        rc = lib.rdt_atrous_level(c.data_ptr(), v.data_ptr(), ptrs[2],
                                  ptrs[3], zgrad.data_ptr(), c_out.data_ptr(),
                                  v_out.data_ptr(), ctypes.addressof(p),
                                  stream)
        _build.check(rc, "rdt_atrous_level")
        svgf_spatial_cuda.launches += 1
        c, v = c_out, v_out
        if lvl + 1 == params.feedback_level:
            feedback = c
    if return_feedback:
        return c, v, feedback
    return c, v


svgf_spatial_cuda.launches = 0
