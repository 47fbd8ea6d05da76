"""K10/K11/K12 wrappers: the box, gaussian and cross-bilateral filters
through the CUDA kernels of ``ops/cuda/filters.cu``.

Counterparts of ``box_filter_pallas`` (``raymarchdenoisercuda_tpu/ops/pallas/
box_tpu.py``), ``gaussian_filter_pallas`` and ``cross_bilateral_pallas``
(``filters_tpu.py``).  CUDA tensors launch the kernels; CPU tensors run the
plain versions ``ops.boxfilter.box_filter``, ``ops.filters.gaussian_filter``
and ``ops.filters.cross_bilateral_filter``.  The filters are forward-only
(the JAX package gives them no VJP): each wrapper raises if an input
requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import FilterParams, FilterType
from .atrous import _EPS, _LOG2E
from .boxfilter import box_filter
from .cuda import _build
from .filters import _gauss_taps, cross_bilateral_filter, gaussian_filter

MAX_RADIUS = 16   # kMaxTaps = 33 in filters.cu


class _GaussParams(ctypes.Structure):
    """Mirror of ``struct GaussParams`` in ``ops/cuda/filters.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in ("C", "H", "W", "radius",
                                            "axis")] + [
        ("taps", ctypes.c_float * (2 * MAX_RADIUS + 1))]


class _CrossParams(ctypes.Structure):
    """Mirror of ``struct CrossParams`` in ``ops/cuda/filters.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "radius",
                                            "pow2_steps")] + [
        (n, ctypes.c_float) for n in ("inv_2sa2", "inv_sz", "sigma_normal",
                                      "eps")] + [
        ("gt", ctypes.c_float * (2 * MAX_RADIUS + 1))]


def _planes(x: torch.Tensor, name: str, radius: int, depth: int):
    """(C, H, W) view of a planar (..., H, W) float32 CUDA tensor and its
    data pointer."""
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius {radius} outside 0..{MAX_RADIUS}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    H, W = x.shape[-2:]
    x3 = x.reshape(-1, H, W)
    return x3, _build.check_input(x3, name, x3.shape, torch.float32, x.device)


def box_filter_cuda(x: torch.Tensor, radius: int = 2,
                    depth: int = 1) -> torch.Tensor:
    """Iterated (2r+1)² box average on planar (..., H, W), as ``box_filter``
    returns it: K10, one launch per level.  Each launch adds one to
    ``box_filter_cuda.launches``."""
    _build.check_no_grad("box_filter_cuda", x)
    if not x.is_cuda:
        return box_filter(x, radius=radius, depth=depth)
    src, ptr = _planes(x, "x", radius, depth)
    C, H, W = src.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bufs = [torch.empty_like(src) for _ in range(min(depth, 2))]
    for level in range(depth):
        dst = bufs[level % 2]
        _build.check(_build.kernels().rdt_box_level(
            ptr, dst.data_ptr(), C, H, W, radius, stream), "rdt_box_level")
        box_filter_cuda.launches += 1
        ptr = dst.data_ptr()
    return dst.reshape(x.shape)


box_filter_cuda.launches = 0


def gaussian_filter_cuda(x: torch.Tensor, radius: int = 2,
                         sigma: float = 2.0, depth: int = 1) -> torch.Tensor:
    """Separable gaussian on planar (..., H, W), iterated ``depth`` times,
    as ``gaussian_filter`` returns it: K11, a row pass and a column pass
    an iteration.  Each launch (pass) adds one to
    ``gaussian_filter_cuda.launches``."""
    _build.check_no_grad("gaussian_filter_cuda", x)
    if not x.is_cuda:
        return gaussian_filter(x, radius=radius, sigma=sigma, depth=depth)
    src, ptr = _planes(x, "x", radius, depth)
    C, H, W = src.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    taps = (ctypes.c_float * (2 * MAX_RADIUS + 1))(*_gauss_taps(radius, sigma))
    tmp, out = torch.empty_like(src), torch.empty_like(src)
    for _ in range(depth):
        for axis, dst in ((0, tmp), (1, out)):
            p = _GaussParams(C=C, H=H, W=W, radius=radius, axis=axis,
                             taps=taps)
            _build.check(_build.kernels().rdt_gauss_pass(
                ptr, dst.data_ptr(), ctypes.addressof(p), stream),
                "rdt_gauss_pass")
            gaussian_filter_cuda.launches += 1
            ptr = dst.data_ptr()
    return out.reshape(x.shape)


gaussian_filter_cuda.launches = 0


def _pow2_steps(sigma_n: float) -> int:
    """k where ``sigma_n == 2**k`` (an integer power of two up to 1024, taken
    by repeated squaring as the TPU kernel takes it), else -1 (``powf``)."""
    ip = int(sigma_n)
    if ip == sigma_n and 0 < ip <= 1024 and (ip & (ip - 1)) == 0:
        return ip.bit_length() - 1
    return -1


def cross_bilateral_cuda(color: torch.Tensor, albedo: torch.Tensor,
                         normal: torch.Tensor, depth: torch.Tensor, *,
                         params: FilterParams = FilterParams(
                             type=FilterType.CROSS)) -> torch.Tensor:
    """Cross-bilateral filter, as ``cross_bilateral_filter`` returns it:
    K12.  Each launch adds one to ``cross_bilateral_cuda.launches``."""
    _build.check_no_grad("cross_bilateral_cuda", color, albedo, normal, depth)
    if not color.is_cuda:
        return cross_bilateral_filter(color, albedo, normal, depth,
                                      params=params)
    r = params.radius
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"radius {r} outside 0..{MAX_RADIUS}")
    H, W = depth.shape
    dev = color.device
    f32 = torch.float32
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (color, "color", (3, H, W)), (albedo, "albedo", (3, H, W)),
        (normal, "normal", (3, H, W)), (depth, "depth", (H, W)))]
    out = torch.empty((3, H, W), dtype=f32, device=dev)
    p = _CrossParams(
        H=H, W=W, radius=r, pow2_steps=_pow2_steps(params.sigma_normal),
        inv_2sa2=_LOG2E / (2.0 * params.sigma_albedo ** 2 + _EPS),
        inv_sz=_LOG2E / (params.sigma_depth + _EPS),
        sigma_normal=params.sigma_normal, eps=_EPS,
        gt=(ctypes.c_float * (2 * MAX_RADIUS + 1))(
            *_gauss_taps(r, params.sigma_space)))
    rc = _build.kernels().rdt_cross_bilateral(
        *ptrs, out.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_cross_bilateral")
    cross_bilateral_cuda.launches += 1
    return out


cross_bilateral_cuda.launches = 0
