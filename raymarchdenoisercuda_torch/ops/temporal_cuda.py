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

Tiles (the sharded pipeline, ``parallel/sharded.py``): K3 takes ``tile``
(history planes and render as canvases around the tile: the
``temporal_accumulate_tile`` path), and the canvas forms, the same kernels
on the (10, Hc, Wc) history canvas, have wrappers of their own, each with
its own launch count: :func:`temporal_accumulate_canvas_cuda` (K3b,
``temporal_accumulate_canvas_pallas``), :func:`gather_canvas_cuda` (K4c,
``_gather_canvas_call``), :func:`gather_canvas_bwd_cuda` and
:func:`gather_canvas_bwd_hist_cuda` (K5c/K6c, ``_gather_canvas_bwd_call``),
and :func:`reproject_gather_canvas_cuda` / 
:func:`temporal_accumulate_canvas_ad_cuda`, the differentiable step on the
canvas (``temporal_accumulate_canvas_local``).

Unbounded motion (``SVGFParams.max_motion=None``): the TPU kernels and
K3-K6 take bounded motion only, and the JAX package runs its jnp step
there.  :func:`temporal_accumulate_cuda` and
:func:`temporal_accumulate_ad_cuda` then run the clamped bilinear gather
(:func:`clamped_gather_cuda`, with the hand-written adjoint
:func:`clamped_gather_bwd_cuda`, both in one autograd Function,
:func:`reproject_clamped_cuda`) and the shared epilogue.  On the card they
stack the history channel-minor, which the gather reads a texel at a time:
:func:`history_stack_channel_minor_cuda` (KGp, one pass, as the planar
``cat`` is; its plain twin is ``history_stack_channel_minor``); the
clamped wrappers lay a planar stack out with KGp first.  K3 itself, its
tile form and K3b keep refusing unbounded motion, as the TPU kernel
does.

Every wrapper launches its kernel for CUDA tensors and runs its plain twin
from ``ops.temporal`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from .common import Tile, canvas_margin
from .cuda import _build
from .temporal import (GRAD_PLANES, N_HIST_PLANES, _ReprojectGather,
                       _canvas_of, bilinear_gather_clamped, gather_bwd_ref,
                       gather_ref, history_from_stack, history_stack,
                       history_stack_channel_minor, temporal_accumulate,
                       temporal_step_ad, temporal_step_clamped)


class _TemporalParams(ctypes.Structure):
    """Mirror of ``struct TemporalParams`` in ``ops/cuda/temporal.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "max_motion", "history_clamp", "boost_frames")] + [
        ("alpha", ctypes.c_float), ("alpha_m", ctypes.c_float)]


class _TemporalTile(ctypes.Structure):
    """Mirror of ``struct TemporalTile`` in ``ops/cuda/temporal.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("Hg", "Wg", "gy0", "gx0", "h_rs", "h_ps", "h_m", "r_rs",
                 "r_ps", "r_m")]


def _tile_struct(tile, hist_strides, hm, render_strides=(0, 0), rm=0):
    """The ``_TemporalTile`` of a launch from the history canvas's (row,
    plane) strides and margin, and the render canvas's; None without a
    tile."""
    if tile is None:
        return None
    (gy0, gx0), (Hg, Wg) = tile.origin, tile.bounds
    return _TemporalTile(Hg=Hg, Wg=Wg, gy0=gy0, gx0=gx0, h_rs=hist_strides[0],
                         h_ps=hist_strides[1], h_m=hm,
                         r_rs=render_strides[0], r_ps=render_strides[1],
                         r_m=rm)


def _ref(struct):
    return None if struct is None else ctypes.addressof(struct)


def _launch_temporal(gbuf, planes, *, params, tile):
    """One launch of K3/K3b.  ``planes``: the 10 history planes as views
    of one canvas geometry (whole frame: contiguous H x W planes) in the
    order colour, moments, length, previous depth, previous normal."""
    if params.max_motion is None:
        raise ValueError("the CUDA temporal kernel requires "
                         "SVGFParams.max_motion (bounded reprojection)")
    H, W = gbuf.depth.shape
    dev = gbuf.device
    f32 = torch.float32
    motion = (gbuf.motion if gbuf.motion is not None
              else torch.zeros((2, H, W), dtype=f32, device=dev))
    color, moments, length, prev_depth, prev_normal = planes
    if tile is None:
        rm = hm = 0
        hist = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
            (color, "history.color", (3, H, W)),
            (moments, "history.moments", (2, H, W)),
            (length, "history.length", (H, W)),
            (prev_depth, "history.prev_depth", (H, W)),
            (prev_normal, "history.prev_normal", (3, H, W)))]
        render = _build.check_input(gbuf.render, "render", (3, H, W), f32,
                                    dev)
    else:
        rm = canvas_margin(gbuf.render, H, W, "render")
        hm = _canvas_of(color.shape, motion, params.max_motion, tile)[1]
        if rm < 3:
            raise ValueError(f"render canvas margin {rm} < 3")
        hc = (H + 2 * hm, W + 2 * hm)
        hist = []
        for t, n, k in ((color, "history.color", 3),
                        (moments, "history.moments", 2),
                        (length, "history.length", None),
                        (prev_depth, "history.prev_depth", None),
                        (prev_normal, "history.prev_normal", 3)):
            hist.append(_build.check_canvas(
                t, n, hc if k is None else (k,) + hc, f32, dev))
            if t.stride(-2) != color.stride(-2) or (
                    k is not None and t.stride(0) != color.stride(0)):
                raise ValueError(f"{n}: not in history.color's canvas "
                                 f"geometry")
        render = _build.check_canvas(gbuf.render, "render",
                                     (3, H + 2 * rm, W + 2 * rm), f32, dev)
    centre = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (motion, "motion", (2, H, W)), (gbuf.depth, "depth", (H, W)),
        (gbuf.normal, "normal", (3, H, W)))]
    integ = torch.empty((3, H, W), dtype=f32, device=dev)
    var = torch.empty((H, W), dtype=f32, device=dev)
    mom = torch.empty((2, H, W), dtype=f32, device=dev)
    n_new = torch.empty((H, W), dtype=f32, device=dev)
    p = _TemporalParams(H=H, W=W, max_motion=params.max_motion,
                        history_clamp=int(params.history_clamp),
                        boost_frames=params.variance_boost_frames,
                        alpha=params.temporal_alpha,
                        alpha_m=params.temporal_moments_alpha)
    t = _tile_struct(tile, (color.stride(-2), color.stride(0)), hm,
                     (gbuf.render.stride(-2), gbuf.render.stride(0)), rm)
    rc = _build.kernels().rdt_temporal(
        render, *centre, *hist, integ.data_ptr(), var.data_ptr(),
        mom.data_ptr(), n_new.data_ptr(), ctypes.addressof(p), _ref(t),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_temporal")
    new_history = History(color=integ, moments=mom, length=n_new,
                          prev_depth=gbuf.depth, prev_normal=gbuf.normal)
    return integ, var, new_history


def temporal_accumulate_cuda(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    tile: Tile = None,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """One temporal step; returns ``(integrated, variance, new_history)`` as
    ``temporal_accumulate`` does.  The kernel needs bounded motion
    (``params.max_motion``), as the TPU kernel does.  ``tile``: the
    history planes are canvases of one geometry around the tile (margin >=
    max_motion + 1) and the render a canvas with margin >= 3, as in
    ``temporal_accumulate(tile=)``.

    With ``max_motion=None`` (and no tile) it runs the clamped gather and
    the plain epilogue instead (see the module docstring).

    Each launch of K3 adds one to ``temporal_accumulate_cuda.launches``."""
    _build.check_no_grad("temporal_accumulate_cuda", gbuf.render,
                         gbuf.motion, history.color, history.moments,
                         history.length)
    if not gbuf.render.is_cuda:
        return temporal_accumulate(gbuf, history, params=params, tile=tile)
    if params.max_motion is None and tile is None:
        return _clamped_step(gbuf, history, params)
    out = _launch_temporal(gbuf, (history.color, history.moments,
                                  history.length, history.prev_depth,
                                  history.prev_normal),
                           params=params, tile=tile)
    temporal_accumulate_cuda.launches += 1
    return out


temporal_accumulate_cuda.launches = 0


def temporal_accumulate_canvas_cuda(
    gbuf: GBuffer,
    canvas: torch.Tensor,
    *,
    params: SVGFParams,
    tile: Tile,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """K3b: the fused temporal step reading the (10, H + 2m, W + 2m)
    history canvas (m >= max_motion + 1, margins holding the neighbours'
    pixels) and a render canvas with margin >= 3; the tile's ``(integrated,
    variance, new_history)``.  Inference only: it raises if an input
    requires grad.

    Each launch adds one to ``temporal_accumulate_canvas_cuda.launches``."""
    _build.check_no_grad("temporal_accumulate_canvas_cuda", gbuf.render,
                         gbuf.motion, canvas)
    if not gbuf.render.is_cuda:
        return temporal_accumulate(gbuf, history_from_stack(canvas),
                                   params=params, tile=tile)
    h = history_from_stack(canvas)
    out = _launch_temporal(gbuf, (h.color, h.moments, h.length, h.prev_depth,
                                  h.prev_normal), params=params, tile=tile)
    temporal_accumulate_canvas_cuda.launches += 1
    return out


temporal_accumulate_canvas_cuda.launches = 0


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _canvas_tile(shape, H, tile):
    """The ``_TemporalTile`` of a contiguous history canvas of ``shape``
    around a tile H rows high (None without a tile)."""
    Hc, Wc = shape[-2:]
    return _tile_struct(tile, (Wc, Hc * Wc), (Hc - H) // 2)


def _launch_gather(stack, motion, max_motion, tile):
    H, W = motion.shape[-2:]
    dev = stack.device
    f32 = torch.float32
    shape = tuple(stack.shape)
    if tile is not None:
        _canvas_of(shape, motion, max_motion, tile)
    elif shape[-2:] != (H, W):
        raise ValueError(f"stack: shape {shape}, expected (10, {H}, {W})")
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (stack, "stack", (N_HIST_PLANES,) + shape[-2:]),
        (motion, "motion", (2, H, W)))]
    out = torch.empty((N_HIST_PLANES, H, W), dtype=f32, device=dev)
    t = _canvas_tile(shape, H, tile)
    rc = _build.kernels().rdt_gather(*ptrs, out.data_ptr(), H, W, max_motion,
                                     _ref(t), _stream(stack))
    _build.check(rc, "rdt_gather")
    return out


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
    out = _launch_gather(stack, motion, max_motion, None)
    gather_cuda.launches += 1
    return out


gather_cuda.launches = 0


def gather_canvas_cuda(canvas: torch.Tensor, motion: torch.Tensor,
                       max_motion: int, *, tile: Tile) -> torch.Tensor:
    """K4c: the tent gather of the tile from its (10, H + 2m, W + 2m)
    history canvas (m >= max_motion + 1); returns the (10, H, W) gathered
    stack as ``gather_ref(tile=)`` does.  No backward of its own
    (:func:`reproject_gather_canvas_cuda` owns the gradient).

    Each launch adds one to ``gather_canvas_cuda.launches``."""
    _build.check_no_grad("gather_canvas_cuda", canvas, motion)
    if not canvas.is_cuda:
        return gather_ref(canvas, motion, max_motion, tile=tile)
    out = _launch_gather(canvas, motion, max_motion, tile)
    gather_canvas_cuda.launches += 1
    return out


gather_canvas_cuda.launches = 0


# the largest max_motion K5/K6's source codes take (kCodeBias - 2 in
# ops/cuda/temporal.cu); a larger bound is cut to the frame's larger side
# plus one, which accepts and rejects the same sources' taps in the frame
GATHER_BWD_CODE_MOTION = 8190


def _gather_bwd(stack, motion, g, max_motion, motion_grad, grad_planes,
                tile=None, canvas_shape=None):
    H, W = g.shape[-2:]
    dev = g.device
    f32 = torch.float32
    if not 1 <= grad_planes <= N_HIST_PLANES:
        raise ValueError(f"grad_planes must be in 1..{N_HIST_PLANES}, "
                         f"got {grad_planes}")
    shape = (N_HIST_PLANES, H, W) if tile is None else tuple(
        stack.shape if stack is not None else canvas_shape)
    if tile is not None:
        _canvas_of(shape, motion, max_motion, tile)
    # a source moved by more than the frame's larger side reaches no texel
    # of it and gives its pixel no motion gradient, accepted or not
    frame = (H, W) if tile is None else tile.bounds
    max_motion = min(max_motion, max(frame) + 1)
    if max_motion > GATHER_BWD_CODE_MOTION:
        raise ValueError(f"the card's K5/K6 take frames of sides up to "
                         f"{GATHER_BWD_CODE_MOTION - 1}, got {frame}")
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (motion, "motion", (2, H, W)), (g, "g", (N_HIST_PLANES, H, W)))]
    hist_ptr = (_build.check_input(stack, "stack", shape, f32, dev)
                if motion_grad else None)
    # the kernel writes every texel of d_hist, zeros beyond grad_planes
    dh = torch.empty(shape, dtype=f32, device=dev)
    dm = (torch.empty if motion_grad else torch.zeros)(
        (2, H, W), dtype=f32, device=dev)
    t = _canvas_tile(shape, H, tile)
    rc = _build.kernels().rdt_gather_bwd(
        hist_ptr, *ptrs, dh.data_ptr(), dm.data_ptr(), H, W, max_motion,
        grad_planes, int(motion_grad), _ref(t), _stream(g))
    _build.check(rc, "rdt_gather_bwd")
    return dh, dm


def gather_bwd_cuda(stack, motion, g, max_motion: int, *,
                    grad_planes: int = N_HIST_PLANES):
    """K5: the full adjoint of K4 (``d_hist`` and ``d_motion``), as
    ``gather_bwd_ref(motion_grad=True)``.  ``d_hist`` is a gather, each
    texel's addends in a fixed order: the same on every launch.  Each
    launch adds one to ``gather_bwd_cuda.launches``."""
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


def gather_canvas_bwd_cuda(canvas, motion, g, max_motion: int, *,
                           tile: Tile, grad_planes: int = N_HIST_PLANES):
    """K5c: the full adjoint of K4c, ``(d_canvas, d_motion)``; ``d_canvas``
    covers the history canvas, margins included (``gather_bwd_ref(tile=,
    motion_grad=True)``).  Each launch adds one to
    ``gather_canvas_bwd_cuda.launches``."""
    _build.check_no_grad("gather_canvas_bwd_cuda", canvas, motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(canvas, motion, g, max_motion, motion_grad=True,
                              grad_planes=grad_planes, tile=tile)
    out = _gather_bwd(canvas, motion, g, max_motion, True, grad_planes, tile)
    gather_canvas_bwd_cuda.launches += 1
    return out


gather_canvas_bwd_cuda.launches = 0


def gather_canvas_bwd_hist_cuda(motion, g, max_motion: int, *, tile: Tile,
                                canvas_shape, grad_planes: int = N_HIST_PLANES):
    """K6c: the ``d_canvas``-only adjoint of K4c (``motion_grad=False``)
    over a canvas of ``canvas_shape``; returns ``(d_canvas, zeros for
    d_motion)``.  Each launch adds one to
    ``gather_canvas_bwd_hist_cuda.launches``."""
    _build.check_no_grad("gather_canvas_bwd_hist_cuda", motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(None, motion, g, max_motion, motion_grad=False,
                              grad_planes=grad_planes, tile=tile,
                              canvas_shape=canvas_shape)
    out = _gather_bwd(None, motion, g, max_motion, False, grad_planes, tile,
                      canvas_shape)
    gather_canvas_bwd_hist_cuda.launches += 1
    return out


gather_canvas_bwd_hist_cuda.launches = 0


def _reproject_canvas_bwd_cuda(canvas, motion, g, max_motion, *, motion_grad,
                               grad_planes, tile, canvas_shape):
    if motion_grad:
        return gather_canvas_bwd_cuda(canvas, motion, g, max_motion,
                                      tile=tile, grad_planes=grad_planes)
    return gather_canvas_bwd_hist_cuda(motion, g, max_motion, tile=tile,
                                       canvas_shape=canvas_shape,
                                       grad_planes=grad_planes)


def reproject_gather_canvas_cuda(canvas: torch.Tensor, motion: torch.Tensor,
                                 max_motion: int, *, tile: Tile,
                                 motion_grad: bool = True,
                                 grad_planes: int = N_HIST_PLANES
                                 ) -> torch.Tensor:
    """Differentiable bounded reprojection of the tile from its history
    canvas (``_reproject_gather_canvas``): forward K4c, backward K5c, or
    K6c when ``motion_grad`` is False; the canvas's gradient covers its
    margins, which the halo exchange's adjoint sends to their owners."""
    return _ReprojectGather.apply(canvas, motion, max_motion, motion_grad,
                                  grad_planes, gather_canvas_cuda,
                                  _reproject_canvas_bwd_cuda, tile)


def _as_channel_minor(stack):
    """A planar (contiguous) CUDA stack of the 10 history planes laid out
    channel-minor by KGp, strides (1, 10·W, 10), as the clamped kernels
    read it; any other stack as it is."""
    if stack.shape[0] == N_HIST_PLANES and stack.is_contiguous():
        return history_stack_channel_minor_cuda(history_from_stack(stack))
    return stack


def _clamped_stack(stack, H, W, dev):
    """``(stack, data pointer, texel stride)`` of a (10, H, W) stack for the
    clamped kernels (:func:`_as_channel_minor`); a layout other than
    channel-minor raises here, a plane count other than 10 in the C entry.
    Keep the returned stack alive until the launch."""
    stack = _as_channel_minor(stack)
    P = stack.shape[0]
    ptr = _build.check_input(stack.permute(1, 2, 0),
                             "stack (channel-minor, as (H, W, P))",
                             (H, W, P), torch.float32, dev)
    return stack, ptr, P


def _launch_clamped(stack, motion):
    P = stack.shape[0]
    H, W = motion.shape[-2:]
    dev = stack.device
    f32 = torch.float32
    stack, ptr, ts = _clamped_stack(stack, H, W, dev)
    mptr = _build.check_input(motion, "motion", (2, H, W), f32, dev)
    out = torch.empty((P, H, W), dtype=f32, device=dev)
    rc = _build.kernels().rdt_clamped_gather(ptr, mptr, out.data_ptr(), H, W,
                                             P, ts, _stream(stack))
    _build.check(rc, "rdt_clamped_gather")
    return out


def clamped_gather_cuda(stack: torch.Tensor,
                        motion: torch.Tensor) -> torch.Tensor:
    """The clamped bilinear gather of a (P, H, W) stack at ``p + motion``
    (unbounded motion; ``ops.temporal.bilinear_gather_clamped``); the output
    is planar, contiguous.  On the card the stack is the 10 history planes,
    channel-minor, or planar and then laid out by KGp first
    (:func:`history_stack_channel_minor_cuda`, one more launch); another
    stack raises.  No backward of its own (:func:`reproject_clamped_cuda`
    owns the gradient): it raises if an input requires grad.

    Each launch adds one to ``clamped_gather_cuda.launches``."""
    _build.check_no_grad("clamped_gather_cuda", stack, motion)
    if not stack.is_cuda:
        return bilinear_gather_clamped(stack, motion)
    out = _launch_clamped(stack, motion)
    clamped_gather_cuda.launches += 1
    return out


clamped_gather_cuda.launches = 0


def clamped_gather_bwd_cuda(stack, motion, g, *,
                            history_grad: bool = True,
                            motion_grad: bool = True):
    """The adjoint of :func:`clamped_gather_cuda` for the cotangent ``g``
    of its output: ``(d_stack, d_motion)``, each None when not asked for;
    ``stack`` as :func:`clamped_gather_cuda` takes it (a planar one is laid
    out by KGp first), ``d_stack`` planar, contiguous.
    Only the leading ``GRAD_PLANES`` planes of ``g`` count (the temporal
    epilogue's previous depth and normal, planes 6-9, feed validity tests
    only, so their cotangent is zero): ``d_stack`` is zero beyond them and
    ``d_motion`` sums over them.  ``d_stack`` sums by atomics into a
    float64 scratch, rounded once to float32: the same on every run to
    within that rounding.  CPU tensors: autograd of
    ``bilinear_gather_clamped`` for ``g`` cut to those planes.

    Each launch adds one to ``clamped_gather_bwd_cuda.launches``."""
    _build.check_no_grad("clamped_gather_bwd_cuda", stack, motion, g)
    if stack.shape[0] < GRAD_PLANES:
        raise ValueError(f"stack needs at least {GRAD_PLANES} planes, got "
                         f"{stack.shape[0]}")
    if not (history_grad or motion_grad):
        return None, None
    if not g.is_cuda:
        g = torch.cat([g[:GRAD_PLANES], torch.zeros_like(g[GRAD_PLANES:])])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      ((stack, history_grad), (motion, motion_grad))]
            out = bilinear_gather_clamped(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], g))
        return tuple(next(grads) if need else None
                     for need in (history_grad, motion_grad))
    P = stack.shape[0]
    H, W = motion.shape[-2:]
    dev = g.device
    f32 = torch.float32
    stack, sptr, ts = _clamped_stack(stack, H, W, dev)
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (motion, "motion", (2, H, W)), (g, "g", (P, H, W)))]
    dh = (torch.empty((P, H, W), dtype=f32, device=dev) if history_grad
          else None)
    # zeroed by the C entry
    scratch = (torch.empty((H, W, GRAD_PLANES), dtype=torch.float64,
                           device=dev) if history_grad else None)
    dm = (torch.empty((2, H, W), dtype=f32, device=dev) if motion_grad
          else None)
    rc = _build.kernels().rdt_clamped_gather_bwd(
        sptr, *ptrs, None if dh is None else dh.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if dm is None else dm.data_ptr(), H, W, GRAD_PLANES, P, ts,
        _stream(g))
    _build.check(rc, "rdt_clamped_gather_bwd")
    clamped_gather_bwd_cuda.launches += 1
    return dh, dm


clamped_gather_bwd_cuda.launches = 0


class _ClampedGather(torch.autograd.Function):
    """The clamped gather with its hand-written adjoint: forward
    :func:`clamped_gather_cuda`, backward :func:`clamped_gather_bwd_cuda`
    (autograd of the gather's index arithmetic would scatter through
    ``index_put_``, the path that cost 53 ms a training step in the
    material lookup)."""

    @staticmethod
    def forward(ctx, stack, motion):
        ctx.save_for_backward(stack, motion)
        return clamped_gather_cuda(stack, motion)

    @staticmethod
    def backward(ctx, g):
        stack, motion = ctx.saved_tensors
        return clamped_gather_bwd_cuda(
            stack, motion, g.contiguous(),
            history_grad=ctx.needs_input_grad[0],
            motion_grad=ctx.needs_input_grad[1])


def reproject_clamped_cuda(stack: torch.Tensor,
                           motion: torch.Tensor) -> torch.Tensor:
    """Differentiable unbounded reprojection of the (10, H, W) history
    stack, channel-minor or planar: the clamped-gather kernel and its
    adjoint on CUDA tensors (the cotangent of planes ``GRAD_PLANES`` on is
    taken as zero, see :func:`clamped_gather_bwd_cuda`; a planar stack is
    laid out by KGp once, under autograd), the plain
    ``bilinear_gather_clamped`` under autograd on CPU tensors."""
    if not stack.is_cuda:
        return bilinear_gather_clamped(stack, motion)
    return _ClampedGather.apply(_as_channel_minor(stack), motion)


class _StackChannelMinor(torch.autograd.Function):
    """KGp with its adjoint: the stack's gradient, cut back into the
    history planes (views; KGb's gradient is planar)."""

    @staticmethod
    def forward(ctx, color, moments, length, prev_depth, prev_normal):
        H, W = length.shape
        dev = length.device
        f32 = torch.float32
        ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
            (color, "history.color", (3, H, W)),
            (moments, "history.moments", (2, H, W)),
            (length, "history.length", (H, W)),
            (prev_depth, "history.prev_depth", (H, W)),
            (prev_normal, "history.prev_normal", (3, H, W)))]
        out = torch.empty((H, W, N_HIST_PLANES), dtype=f32, device=dev)
        rc = _build.kernels().rdt_stack_channel_minor(
            *ptrs, out.data_ptr(), H * W, _stream(length))
        _build.check(rc, "rdt_stack_channel_minor")
        history_stack_channel_minor_cuda.launches += 1
        return out.permute(2, 0, 1)

    @staticmethod
    def backward(ctx, g):
        return g[0:3], g[3:5], g[5], g[6], g[7:10]


def history_stack_channel_minor_cuda(history: History) -> torch.Tensor:
    """KGp: the (10, H, W) history stack laid out channel-minor, strides
    (1, 10·W, 10), as ``history_stack_channel_minor`` builds it (its plain
    twin, which CPU tensors run).  Differentiable.

    Each launch adds one to ``history_stack_channel_minor_cuda.launches``."""
    if not history.length.is_cuda:
        return history_stack_channel_minor(history)
    return _StackChannelMinor.apply(history.color, history.moments,
                                    history.length, history.prev_depth,
                                    history.prev_normal)


history_stack_channel_minor_cuda.launches = 0


def _clamped_step(gbuf, history, params):
    """The unbounded-motion step through :func:`reproject_clamped_cuda`, on
    the history stacked channel-minor by KGp on the card (planar, as the
    plain step stacks it, on the CPU)."""
    return temporal_step_clamped(
        gbuf, history, params, reproject_clamped_cuda,
        history_stack_channel_minor_cuda if gbuf.render.is_cuda
        else history_stack)


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
    new_history)``.  With ``max_motion=None``: the clamped gather and its
    adjoint (:func:`reproject_clamped_cuda`), whose motion gradient flows
    wherever motion requires grad, as in ``temporal_accumulate_ad``."""
    if params.max_motion is None:
        return _clamped_step(gbuf, history, params)
    return temporal_step_ad(gbuf, history, params, reproject_gather_cuda,
                            motion_grad=motion_grad, grad_planes=GRAD_PLANES)


def temporal_accumulate_canvas_ad_cuda(
    gbuf: GBuffer,
    canvas: torch.Tensor,
    *,
    params: SVGFParams,
    tile: Tile,
    motion_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """The differentiable temporal step of a tile on its history canvas
    (``temporal_accumulate_canvas_local``): K4c, K5c/K6c in the backward,
    and the plain epilogue on the render canvas (margin >= 3).  Returns
    the tile's ``(integrated, variance, new_history)``."""
    return temporal_step_ad(gbuf, canvas, params,
                            reproject_gather_canvas_cuda,
                            motion_grad=motion_grad, grad_planes=GRAD_PLANES,
                            tile=tile)
