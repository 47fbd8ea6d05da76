"""K10/K11/K12 wrappers: the box, gaussian and cross-bilateral filters
through the CUDA kernels of ``ops/cuda/filters.cu``.

Counterparts of ``box_filter_pallas`` (``raymarchdenoisercuda_tpu/ops/pallas/
box_tpu.py``), ``gaussian_filter_pallas`` and ``cross_bilateral_pallas``
(``filters_tpu.py``).  CUDA tensors launch the kernels; CPU tensors run the
plain versions ``ops.boxfilter.box_filter``, ``ops.filters.gaussian_filter``
and ``ops.filters.cross_bilateral_filter``.  The filters are forward-only
(the JAX package gives them no VJP): each wrapper raises if an input
requires grad.  Any radius: from :data:`BOX_PASS_RADIUS` (K10) and
:data:`GAUSS_PASS_RADIUS` (K11) up, K10 and K11 run as two 1-D passes a
level (``rdt_filter_pass``, through a global intermediate), the gaussian
taps and denominators in a device array (:func:`pass_taps`); below, the
2-D bodies compiled at r 0-4, the gaussian taps in the launch's parameter
struct.  K12 runs its staged tile up to r 4 and its
rolling-row tile above, its taps past r 16 in a device array
(:func:`_wide_taps`), as the à-trous sweep's are.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import FilterParams, FilterType
from .atrous import _EPS, _LOG2E
from .atrous_cuda import LaunchCount
from .boxfilter import box_filter
from .cuda import _build
from .filters import _gauss_taps, cross_bilateral_filter, gaussian_filter
from ..utils.tiling import BOX_PASS_RADIUS, GAUSS_PASS_RADIUS

# the largest radius whose 2r + 1 taps ride in CrossParams (kMaxTaps = 33
# in filters.cu)
STRUCT_RADIUS = 16
# K12's staged form takes r up to 4 (kMaxStagedRadius), the rolling-row
# tile any above
STAGED_CROSS_RADIUS = 4
# The largest halo r·levels that one K10 launch stages.  On the H100
# (``utils/profile.py box``, PERF.md PR 15) a call split so that each
# launch's halo is at most 8 ran no slower than any finer split (r1 d3-d8,
# r2 d2-d4, r3 d2, r4 d2 in one launch; r2 d5 as 3 + 2 levels, r3 d3 as
# 2 + 1); larger halos lost (r3 d3 in one launch 1.02x, r2 d5 1.03x the
# split).
BOX_HALO_CAP = 8
# BOX_PASS_RADIUS and GAUSS_PASS_RADIUS (utils/tiling.py, both 5): the
# smallest radius K10 and K11 run as 1-D passes; the 2-D bodies are
# compiled at r 0-4 only.  On the H100 at 1080p x 3 planes, device time in
# turns (chip_smoke.py phase 3 and kernel_ab; PERF.md section 6), the 2-D
# bodies won at r 4 (K10 0.0397 ms against the passes' 0.0500, K11 0.0355
# against 0.0498) and lost from r 5 (K10 r5 0.1047 against 0.0507, r16
# 0.5659 against 0.0617; K11 r5 0.0606 against 0.0536, r16 0.1212 against
# 0.0821), at depth 1 and 2 alike.


class _GaussParams(ctypes.Structure):
    """Mirror of ``struct GaussParams`` in ``ops/cuda/filters.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in ("C", "H", "W", "radius")] + [
        ("taps", ctypes.c_float * (2 * GAUSS_PASS_RADIUS - 1))]


class _CrossParams(ctypes.Structure):
    """Mirror of ``struct CrossParams`` in ``ops/cuda/filters.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "radius",
                                            "pow2_steps")] + [
        (n, ctypes.c_float) for n in ("inv_2sa2", "inv_sz", "sigma_normal",
                                      "eps")] + [
        ("gt", ctypes.c_float * (2 * STRUCT_RADIUS + 1))]


def _planes(x: torch.Tensor, name: str, radius: int, depth: int):
    """(C, H, W) view of a planar (..., H, W) float32 CUDA tensor and its
    data pointer."""
    if radius < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {radius}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    H, W = x.shape[-2:]
    x3 = x.reshape(-1, H, W)
    return x3, _build.check_input(x3, name, x3.shape, torch.float32, x.device)


_wide_taps_cache = {}


def _struct_taps(radius: int, sigma: float, most: int = STRUCT_RADIUS):
    """A parameter struct's taps, room for radius ``most``: the 2r + 1
    gaussian taps up to it, zeros above it (the kernel reads the device
    array then)."""
    taps = _gauss_taps(radius, sigma) if radius <= most else ()
    return (ctypes.c_float * (2 * most + 1))(*taps)


def _wide_taps(radius: int, sigma: float, dev):
    """The device array of the 2r + 1 gaussian taps for r above
    :data:`STRUCT_RADIUS`, or None (NULL); one array a (radius, sigma,
    device), kept for reuse."""
    if radius <= STRUCT_RADIUS:
        return None
    key = (radius, float(sigma), str(dev))
    if key not in _wide_taps_cache:
        _wide_taps_cache[key] = torch.tensor(
            _gauss_taps(radius, sigma), dtype=torch.float32, device=dev)
    return _wide_taps_cache[key]


_pass_taps_cache = {}


def pass_taps(radius: int, sigma: float, H: int, W: int) -> torch.Tensor:
    """The gaussian's 1-D passes' taps (CPU, float32): the 2r + 1 taps, then
    the denominators of a pass along y by row (H) and along x by column
    (W), each the sum of the taps that fall in the frame, added in order
    from +0.0 in float32 as the twin adds them (``den + t·m``)."""
    taps = _gauss_taps(radius, sigma)
    dens = []
    for n in (H, W):
        pos = torch.arange(n)
        den = torch.zeros(n, dtype=torch.float32)
        for k, t in enumerate(taps):
            src = pos + (k - radius)
            den = den + t * ((src >= 0) & (src < n)).to(torch.float32)
        dens.append(den)
    return torch.cat([torch.tensor(taps, dtype=torch.float32)] + dens)


def _pass_taps(radius: int, sigma: float, H: int, W: int, dev):
    """:func:`pass_taps` on ``dev``, one array a (radius, sigma, H, W,
    device), kept for reuse."""
    key = (radius, float(sigma), H, W, str(dev))
    if key not in _pass_taps_cache:
        _pass_taps_cache[key] = pass_taps(radius, sigma, H, W).to(dev)
    return _pass_taps_cache[key]


def _ptr(t):
    return None if t is None else t.data_ptr()


def box_level_groups(radius: int, depth: int,
                     cap: int = BOX_HALO_CAP) -> list:
    """The levels each K10 launch runs for a ``depth``-level call: as few
    launches as keep every launch's halo ``radius · levels`` within ``cap``
    (one level a launch where the radius alone exceeds it), the levels
    spread evenly over them."""
    most = depth if radius == 0 else max(1, cap // radius)
    n = -(-depth // most)
    q, extra = divmod(depth, n)
    return [q + 1] * extra + [q] * (n - extra)


def _ping_pong(n: int, out: torch.Tensor):
    """The destinations of ``n`` chained launches that end in ``out``: it
    and, only where ``n > 1``, one intermediate buffer, alternating."""
    tmp = torch.empty_like(out) if n > 1 else None
    return [out if (n - 1 - i) % 2 == 0 else tmp for i in range(n)]


def box_filter_cuda(x: torch.Tensor, radius: int = 2,
                    depth: int = 1) -> torch.Tensor:
    """Iterated (2r+1)² box average on planar (..., H, W), as ``box_filter``
    returns it: K10, from :data:`BOX_PASS_RADIUS` up two 1-D passes a
    level, below it the 2-D body, which runs the levels of a launch in
    shared memory, as many as :func:`box_level_groups` gives it.  Each
    launch adds one to ``box_filter_cuda.launches``, a pass one to
    ``box_filter_cuda.passes.launches`` too."""
    _build.check_no_grad("box_filter_cuda", x)
    if not x.is_cuda:
        return box_filter(x, radius=radius, depth=depth)
    if radius >= BOX_PASS_RADIUS:
        return _separable(x, radius, depth, None, box_filter_cuda)
    return _box_launches(x, radius, box_level_groups(radius, depth))


def _separable(x: torch.Tensor, radius: int, depth: int, taps, counter):
    """K10 (``taps`` None) or K11 (``taps`` from :func:`_pass_taps`) as 1-D
    passes on a CUDA tensor: each level or iteration a pass along y into an
    intermediate and a pass along x from it, each launch adding one to
    ``counter.launches`` and ``counter.passes.launches``."""
    src, ptr = _planes(x, "x", radius, depth)
    C, H, W = src.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mid = torch.empty_like(src)
    out = torch.empty_like(src)
    for dst in _ping_pong(depth, out):
        for p_in, p_out, along_y in ((ptr, mid.data_ptr(), 1),
                                     (mid.data_ptr(), dst.data_ptr(), 0)):
            _build.check(_build.kernels().rdt_filter_pass(
                p_in, p_out, C, H, W, radius, _ptr(taps), along_y, stream),
                "rdt_filter_pass")
            counter.launches += 1
            counter.passes.launches += 1
        ptr = dst.data_ptr()
    return out.reshape(x.shape)


def _box_launches(x: torch.Tensor, radius: int, groups) -> torch.Tensor:
    """K10's 2-D body (r below :data:`BOX_PASS_RADIUS`) on a CUDA tensor,
    launch i running ``groups[i]`` levels: the same floats for any grouping
    of ``sum(groups)`` levels."""
    src, ptr = _planes(x, "x", radius, sum(groups))
    C, H, W = src.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(src)
    for levels, dst in zip(groups, _ping_pong(len(groups), out)):
        _build.check(_build.kernels().rdt_box_filter(
            ptr, dst.data_ptr(), C, H, W, radius, levels, stream),
            "rdt_box_filter")
        box_filter_cuda.launches += 1
        ptr = dst.data_ptr()
    return out.reshape(x.shape)


box_filter_cuda.launches = 0
box_filter_cuda.passes = LaunchCount()


def gaussian_filter_cuda(x: torch.Tensor, radius: int = 2,
                         sigma: float = 2.0, depth: int = 1) -> torch.Tensor:
    """Separable gaussian on planar (..., H, W), iterated ``depth`` times,
    as ``gaussian_filter`` returns it: K11, from :data:`GAUSS_PASS_RADIUS`
    up one launch a pass, below it both passes of an iteration in one
    launch.  Each launch adds one to ``gaussian_filter_cuda.launches``, a
    pass one to ``gaussian_filter_cuda.passes.launches`` too."""
    _build.check_no_grad("gaussian_filter_cuda", x)
    if not x.is_cuda:
        return gaussian_filter(x, radius=radius, sigma=sigma, depth=depth)
    if radius >= GAUSS_PASS_RADIUS:
        return _gaussian_passes(x, radius, sigma, depth)
    return _gaussian_launches(x, radius, sigma, depth)


def _gaussian_passes(x: torch.Tensor, radius: int, sigma: float,
                     depth: int) -> torch.Tensor:
    """K11 as 1-D passes on a CUDA tensor (:func:`_separable`)."""
    H, W = x.shape[-2:]
    return _separable(x, radius, depth,
                      _pass_taps(radius, sigma, H, W, x.device),
                      gaussian_filter_cuda)


def _gaussian_launches(x: torch.Tensor, radius: int, sigma: float,
                       depth: int) -> torch.Tensor:
    """K11's 2-D body (r below :data:`GAUSS_PASS_RADIUS`) on a CUDA
    tensor, one launch an iteration."""
    src, ptr = _planes(x, "x", radius, depth)
    C, H, W = src.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = _GaussParams(C=C, H=H, W=W, radius=radius,
                     taps=_struct_taps(radius, sigma,
                                       GAUSS_PASS_RADIUS - 1))
    out = torch.empty_like(src)
    for dst in _ping_pong(depth, out):
        _build.check(_build.kernels().rdt_gaussian_filter(
            ptr, dst.data_ptr(), ctypes.addressof(p), stream),
            "rdt_gaussian_filter")
        gaussian_filter_cuda.launches += 1
        ptr = dst.data_ptr()
    return out.reshape(x.shape)


gaussian_filter_cuda.launches = 0
gaussian_filter_cuda.passes = LaunchCount()


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
    K12 (past r 4 its rolling-row tile).  Each launch adds one to
    ``cross_bilateral_cuda.launches``, and one past r 4 to
    ``cross_bilateral_cuda.rolling.launches`` too."""
    _build.check_no_grad("cross_bilateral_cuda", color, albedo, normal, depth)
    if not color.is_cuda:
        return cross_bilateral_filter(color, albedo, normal, depth,
                                      params=params)
    r = params.radius
    if r < 0:
        raise ValueError(f"radius must be >= 0, got {r}")
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
        gt=_struct_taps(r, params.sigma_space))
    rc = _build.kernels().rdt_cross_bilateral(
        *ptrs, out.data_ptr(), ctypes.addressof(p),
        _ptr(_wide_taps(r, params.sigma_space, dev)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_cross_bilateral")
    cross_bilateral_cuda.launches += 1
    cross_bilateral_cuda.rolling.launches += int(r > STAGED_CROSS_RADIUS)
    return out


cross_bilateral_cuda.launches = 0
cross_bilateral_cuda.rolling = LaunchCount()
