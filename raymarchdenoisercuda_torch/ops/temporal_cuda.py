"""K3-K6 wrappers: the temporal step through the CUDA kernels of
``ops/cuda/temporal.cu``.

* :func:`temporal_accumulate_cuda` (K3) is ``temporal_accumulate_pallas``,
  the fused inference step: no gradient (it raises on an input that
  requires grad).
* :func:`temporal_accumulate_ad_cuda` is ``temporal_accumulate_pallas_ad``,
  the differentiable step of training: the reprojection
  (:func:`reproject_gather_cuda`, forward K4, backward K5 or, without the
  motion gradient, K6) plus the plain epilogue, which autograd
  differentiates.

Every wrapper launches its kernel for CUDA tensors and runs its plain twin
from ``ops.temporal`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from .cuda import _build
from .temporal import (GRAD_PLANES, N_HIST_PLANES, _ReprojectGather,
                       gather_bwd_ref, gather_ref, temporal_accumulate,
                       temporal_step_ad)


class _TemporalParams(ctypes.Structure):
    """Mirror of ``struct TemporalParams`` in ``ops/cuda/temporal.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "max_motion", "history_clamp", "boost_frames")] + [
        ("alpha", ctypes.c_float), ("alpha_m", ctypes.c_float)]


def temporal_accumulate_cuda(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """One temporal step; returns ``(integrated, variance, new_history)`` as
    ``temporal_accumulate`` does.  The kernel needs bounded motion
    (``params.max_motion``), as the TPU kernel does.

    Each launch adds one to ``temporal_accumulate_cuda.launches``."""
    _build.check_no_grad("temporal_accumulate_cuda", gbuf.render,
                         gbuf.motion, history.color, history.moments,
                         history.length)
    if not gbuf.render.is_cuda:
        return temporal_accumulate(gbuf, history, params=params)
    if params.max_motion is None:
        raise ValueError("the CUDA temporal kernel requires "
                         "SVGFParams.max_motion (bounded reprojection)")
    H, W = gbuf.shape
    dev = gbuf.device
    f32 = torch.float32
    motion = (gbuf.motion if gbuf.motion is not None
              else torch.zeros((2, H, W), dtype=f32, device=dev))
    ins = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (gbuf.render, "render", (3, H, W)), (motion, "motion", (2, H, W)),
        (gbuf.depth, "depth", (H, W)), (gbuf.normal, "normal", (3, H, W)),
        (history.color, "history.color", (3, H, W)),
        (history.moments, "history.moments", (2, H, W)),
        (history.length, "history.length", (H, W)),
        (history.prev_depth, "history.prev_depth", (H, W)),
        (history.prev_normal, "history.prev_normal", (3, H, W)))]
    integ = torch.empty((3, H, W), dtype=f32, device=dev)
    var = torch.empty((H, W), dtype=f32, device=dev)
    moments = torch.empty((2, H, W), dtype=f32, device=dev)
    length = torch.empty((H, W), dtype=f32, device=dev)
    p = _TemporalParams(H=H, W=W, max_motion=params.max_motion,
                        history_clamp=int(params.history_clamp),
                        boost_frames=params.variance_boost_frames,
                        alpha=params.temporal_alpha,
                        alpha_m=params.temporal_moments_alpha)
    rc = _build.kernels().rdt_temporal(
        *ins, integ.data_ptr(), var.data_ptr(), moments.data_ptr(),
        length.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_temporal")
    temporal_accumulate_cuda.launches += 1
    new_history = History(color=integ, moments=moments, length=length,
                          prev_depth=gbuf.depth, prev_normal=gbuf.normal)
    return integ, var, new_history


temporal_accumulate_cuda.launches = 0


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_cuda(stack: torch.Tensor, motion: torch.Tensor,
                max_motion: int) -> torch.Tensor:
    """K4: bounded tent gather of the (10, H, W) history stack; returns
    the gathered stack as ``ops.temporal.gather_ref`` does.  No backward of
    its own (:func:`reproject_gather_cuda` owns the gradient): it raises if
    an input requires grad.

    Each launch adds one to ``gather_cuda.launches``."""
    _build.check_no_grad("gather_cuda", stack, motion)
    if not stack.is_cuda:
        return gather_ref(stack, motion, max_motion)
    _, H, W = stack.shape
    dev = stack.device
    f32 = torch.float32
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (stack, "stack", (N_HIST_PLANES, H, W)), (motion, "motion", (2, H, W)))]
    out = torch.empty((N_HIST_PLANES, H, W), dtype=f32, device=dev)
    rc = _build.kernels().rdt_gather(*ptrs, out.data_ptr(), H, W, max_motion,
                                     _stream(stack))
    _build.check(rc, "rdt_gather")
    gather_cuda.launches += 1
    return out


gather_cuda.launches = 0


def _gather_bwd(stack, motion, g, max_motion, motion_grad, grad_planes):
    H, W = g.shape[-2:]
    dev = g.device
    f32 = torch.float32
    if not 1 <= grad_planes <= N_HIST_PLANES:
        raise ValueError(f"grad_planes must be in 1..{N_HIST_PLANES}, "
                         f"got {grad_planes}")
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (motion, "motion", (2, H, W)), (g, "g", (N_HIST_PLANES, H, W)))]
    hist_ptr = (_build.check_input(stack, "stack", (N_HIST_PLANES, H, W),
                                   f32, dev) if motion_grad else None)
    dh = torch.zeros((N_HIST_PLANES, H, W), dtype=f32, device=dev)
    dm = (torch.empty if motion_grad else torch.zeros)(
        (2, H, W), dtype=f32, device=dev)
    rc = _build.kernels().rdt_gather_bwd(
        hist_ptr, *ptrs, dh.data_ptr(), dm.data_ptr(), H, W, max_motion,
        grad_planes, int(motion_grad), _stream(g))
    _build.check(rc, "rdt_gather_bwd")
    return dh, dm


def gather_bwd_cuda(stack, motion, g, max_motion: int, *,
                    grad_planes: int = N_HIST_PLANES):
    """K5: the full adjoint of K4 (``d_hist`` and ``d_motion``), as
    ``gather_bwd_ref(motion_grad=True)``.  ``d_hist`` sums by atomics, in
    no fixed order.  Each launch adds one to ``gather_bwd_cuda.launches``."""
    _build.check_no_grad("gather_bwd_cuda", stack, motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(stack, motion, g, max_motion, motion_grad=True,
                              grad_planes=grad_planes)
    out = _gather_bwd(stack, motion, g, max_motion, True, grad_planes)
    gather_bwd_cuda.launches += 1
    return out


gather_bwd_cuda.launches = 0


def gather_bwd_hist_cuda(motion, g, max_motion: int, *,
                         grad_planes: int = N_HIST_PLANES):
    """K6: the ``d_hist``-only adjoint of K4 (``motion_grad=False``); returns
    ``(d_hist, zeros for d_motion)``.  Each launch adds one to
    ``gather_bwd_hist_cuda.launches``."""
    _build.check_no_grad("gather_bwd_hist_cuda", motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(None, motion, g, max_motion, motion_grad=False,
                              grad_planes=grad_planes)
    out = _gather_bwd(None, motion, g, max_motion, False, grad_planes)
    gather_bwd_hist_cuda.launches += 1
    return out


gather_bwd_hist_cuda.launches = 0


def _reproject_bwd_cuda(stack, motion, g, max_motion, *, motion_grad,
                        grad_planes):
    if motion_grad:
        return gather_bwd_cuda(stack, motion, g, max_motion,
                               grad_planes=grad_planes)
    return gather_bwd_hist_cuda(motion, g, max_motion,
                                grad_planes=grad_planes)


def reproject_gather_cuda(stack: torch.Tensor, motion: torch.Tensor,
                          max_motion: int, *, motion_grad: bool = True,
                          grad_planes: int = N_HIST_PLANES) -> torch.Tensor:
    """Differentiable bounded reprojection of the (10, H, W) history stack
    (the JAX package's ``_reproject_gather``): forward K4, backward K5, or
    K6 when ``motion_grad`` is False."""
    return _ReprojectGather.apply(stack, motion, max_motion, motion_grad,
                                  grad_planes, gather_cuda,
                                  _reproject_bwd_cuda)


def temporal_accumulate_ad_cuda(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    motion_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """The differentiable temporal step (``temporal_accumulate_pallas_ad``):
    the K4-K6 reprojection, then the plain epilogue.  Values as
    ``temporal_accumulate``; returns ``(integrated, variance,
    new_history)``."""
    return temporal_step_ad(gbuf, history, params, reproject_gather_cuda,
                            motion_grad=motion_grad, grad_planes=GRAD_PLANES)
