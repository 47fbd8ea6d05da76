"""K3 wrapper: the fused inference temporal step through the CUDA kernel.

Counterpart of ``temporal_accumulate_pallas`` in
``raymarchdenoisercuda_tpu/ops/pallas/temporal_tpu.py``.  CUDA tensors run
``ops/cuda/temporal.cu``; CPU tensors run the plain version
``ops.temporal.temporal_accumulate``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from .cuda import _build
from .temporal import temporal_accumulate


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
