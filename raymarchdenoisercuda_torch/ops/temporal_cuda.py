"""K3-K6 wrappers: the temporal step through the CUDA kernels of
``ops/cuda/temporal.cu``.

* :func:`temporal_accumulate_cuda` (K3) is ``temporal_accumulate_pallas``,
  the fused inference step, and with unbounded motion K3's unbounded step:
  no gradient (it raises on an input that requires grad).
* :func:`temporal_accumulate_ad_cuda` is ``temporal_accumulate_pallas_ad``,
  the differentiable step of training.  Where only the render takes a
  gradient (bounded motion, no gradient asked of the history or the
  motion: the material fit's step), it is one autograd Function,
  ``_FusedTemporalStep``: forward K3, backward K16
  (:func:`temporal_bwd_cuda`, the epilogue's adjoint in gather form).
  Elsewhere it is the reprojection (:func:`reproject_gather_cuda`, forward
  K4, backward K5 or, without the motion gradient, K6) plus the plain
  epilogue, which autograd differentiates.

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

Unbounded motion (``SVGFParams.max_motion=None``): the TPU kernels take
bounded motion only, and the JAX package runs its jnp step there
(``bilinear_gather_many``, then ``_temporal_epilogue``; no Pallas
kernel).  :func:`temporal_accumulate_cuda` runs K3's unbounded step: one
launch of K3's body whose reprojection is the clamped bilinear gather
(``temporal_kernel<false, 1, true>``, C entry ``rdt_temporal`` with
``TemporalParams.max_motion = -1``), bit-equal to the route it replaced
(the history stacked by KGp, KG, the plain epilogue).  Its bound is K3's,
104 B a pixel (0.2575 ms at 3840x2160); it reads the history planar, as
K3 does: on the served frames' coherent motion that beat KGp's
channel-minor stack, 0.394 ms against 0.376 + KGp's 0.216 at 3840x2160
(H100, device time; ``ops/cuda/temporal.cu``'s header).
:func:`temporal_accumulate_ad_cuda` runs the clamped gather
(:func:`clamped_gather_cuda`, with the hand-written adjoint
:func:`clamped_gather_bwd_cuda`, both in one autograd Function,
:func:`reproject_clamped_cuda`) and the shared epilogue under autograd.
On the card that route stacks the history channel-minor, which the
gather reads a texel at a time: :func:`history_stack_channel_minor_cuda`
(KGp, one pass, as the planar ``cat`` is; its plain twin is
``history_stack_channel_minor``); the clamped wrappers lay a planar stack
out with KGp first.  K3's tile form and K3b keep refusing unbounded
motion, as the TPU kernel does.

Every wrapper launches its kernel for CUDA tensors and runs its plain twin
from ``ops.temporal`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import SVGFParams
from ..gbuffer import GBuffer, History
from ..utils.tiling import GATHER_STAGED_MAX_MOTION, scatter_workspace_ints
from ..utils.timing import count, spanned
from .atrous_cuda import LaunchCount
from .common import Tile, canvas_margin
from .cuda import _build
from .temporal import (GRAD_PLANES, N_HIST_PLANES, _ReprojectGather,
                       _canvas_of, bilinear_gather_clamped, gather_bwd_ref,
                       gather_ref, history_from_stack, history_stack,
                       history_stack_channel_minor, temporal_accumulate,
                       temporal_step_ad, temporal_step_bwd_ref,
                       temporal_step_clamped)


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
    order colour, moments, length, previous depth, previous normal.
    ``max_motion=None`` on the whole frame: K3's unbounded step (the
    clamped gather); a tile takes bounded motion only."""
    if params.max_motion is None and tile is not None:
        raise ValueError("the CUDA temporal kernel's tile form requires "
                         "SVGFParams.max_motion (bounded reprojection)")
    if params.max_motion is not None and params.max_motion < 0:
        raise ValueError(f"max_motion must be >= 0 or None, got "
                         f"{params.max_motion}")
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
    # -1: the unbounded step
    p = _TemporalParams(H=H, W=W, max_motion=(-1 if params.max_motion is None
                                              else params.max_motion),
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
    ``temporal_accumulate`` does.  ``tile``: the history planes are
    canvases of one geometry around the tile (margin >= max_motion + 1)
    and the render a canvas with margin >= 3, as in
    ``temporal_accumulate(tile=)``; bounded motion only, as the TPU
    kernel takes.

    With ``max_motion=None`` and no tile, K3's unbounded step: the clamped
    gather in K3's body (see the module docstring).  While spans record,
    that route adds one to the counters ``temporal_unbounded`` and
    ``temporal_unbounded_fused``, on either device.

    Each launch of K3 adds one to ``temporal_accumulate_cuda.launches``."""
    _build.check_no_grad("temporal_accumulate_cuda", gbuf.render,
                         gbuf.motion, history.color, history.moments,
                         history.length)
    unbounded = params.max_motion is None and tile is None
    if unbounded:
        count("temporal_unbounded_fused", 1)
    if not gbuf.render.is_cuda:
        # the plain step counts temporal_unbounded itself
        return temporal_accumulate(gbuf, history, params=params, tile=tile)
    if unbounded:
        count("temporal_unbounded", 1)
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


def _gather_bwd(stack, motion, g, max_motion, motion_grad, grad_planes,
                tile=None, canvas_shape=None, scatter=None, counter=None):
    """K5/K6 (K5c/K6c with ``tile``): the staged gather up to
    ``GATHER_STAGED_MAX_MOTION``, the bucketed scatter above it (or, with
    ``scatter`` True, at any bound: the same floats).  The launch adds one
    to ``counter.launches`` (the calling wrapper), and a scatter launch to
    ``counter.scatter.launches`` too."""
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
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (motion, "motion", (2, H, W)), (g, "g", (N_HIST_PLANES, H, W)))]
    hist_ptr = (_build.check_input(stack, "stack", shape, f32, dev)
                if motion_grad else None)
    # the kernel writes every texel of d_hist, zeros beyond grad_planes
    dh = torch.empty(shape, dtype=f32, device=dev)
    dm = (torch.empty if motion_grad else torch.zeros)(
        (2, H, W), dtype=f32, device=dev)
    t = _canvas_tile(shape, H, tile)
    if scatter is None:
        scatter = max_motion > GATHER_STAGED_MAX_MOTION
    n_ws = (scatter_workspace_ints(H, W, (shape[-2] - H) // 2) if scatter
            else 0)
    if n_ws >= 2 ** 31:
        raise ValueError(f"K5/K6: a workspace of {n_ws} ints exceeds the "
                         f"kernels' int32 indexing")
    ws = torch.empty(n_ws, dtype=torch.int32, device=dev) if n_ws else None
    rc = _build.kernels().rdt_gather_bwd(
        hist_ptr, *ptrs, dh.data_ptr(), dm.data_ptr(), H, W, max_motion,
        grad_planes, int(motion_grad), _ref(t),
        None if ws is None else ws.data_ptr(), n_ws, _stream(g))
    _build.check(rc, "rdt_gather_bwd")
    if counter is not None:
        counter.launches += 1
        counter.scatter.launches += int(scatter)
    return dh, dm


def gather_bwd_cuda(stack, motion, g, max_motion: int, *,
                    grad_planes: int = N_HIST_PLANES):
    """K5: the full adjoint of K4 (``d_hist`` and ``d_motion``), as
    ``gather_bwd_ref(motion_grad=True)``.  ``d_hist`` is a gather, each
    texel's addends in a fixed order: the same on every launch.  Each
    launch adds one to ``gather_bwd_cuda.launches``, and one past
    max_motion 59 (the scatter route) to ``gather_bwd_cuda.scatter.launches``
    too."""
    _build.check_no_grad("gather_bwd_cuda", stack, motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(stack, motion, g, max_motion, motion_grad=True,
                              grad_planes=grad_planes)
    return _gather_bwd(stack, motion, g, max_motion, True, grad_planes,
                       counter=gather_bwd_cuda)


gather_bwd_cuda.launches = 0
gather_bwd_cuda.scatter = LaunchCount()


def gather_bwd_hist_cuda(motion, g, max_motion: int, *,
                         grad_planes: int = N_HIST_PLANES):
    """K6: the ``d_hist``-only adjoint of K4 (``motion_grad=False``); returns
    ``(d_hist, zeros for d_motion)``.  Each launch adds one to
    ``gather_bwd_hist_cuda.launches`` (past max_motion 59 to its
    ``.scatter.launches`` too)."""
    _build.check_no_grad("gather_bwd_hist_cuda", motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(None, motion, g, max_motion, motion_grad=False,
                              grad_planes=grad_planes)
    return _gather_bwd(None, motion, g, max_motion, False, grad_planes,
                       counter=gather_bwd_hist_cuda)


gather_bwd_hist_cuda.launches = 0
gather_bwd_hist_cuda.scatter = LaunchCount()


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
    ``gather_canvas_bwd_cuda.launches`` (past max_motion 59 to its
    ``.scatter.launches`` too)."""
    _build.check_no_grad("gather_canvas_bwd_cuda", canvas, motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(canvas, motion, g, max_motion, motion_grad=True,
                              grad_planes=grad_planes, tile=tile)
    return _gather_bwd(canvas, motion, g, max_motion, True, grad_planes,
                       tile, counter=gather_canvas_bwd_cuda)


gather_canvas_bwd_cuda.launches = 0
gather_canvas_bwd_cuda.scatter = LaunchCount()


def gather_canvas_bwd_hist_cuda(motion, g, max_motion: int, *, tile: Tile,
                                canvas_shape, grad_planes: int = N_HIST_PLANES):
    """K6c: the ``d_canvas``-only adjoint of K4c (``motion_grad=False``)
    over a canvas of ``canvas_shape``; returns ``(d_canvas, zeros for
    d_motion)``.  Each launch adds one to
    ``gather_canvas_bwd_hist_cuda.launches`` (past max_motion 59 to its
    ``.scatter.launches`` too)."""
    _build.check_no_grad("gather_canvas_bwd_hist_cuda", motion, g)
    if not g.is_cuda:
        return gather_bwd_ref(None, motion, g, max_motion, motion_grad=False,
                              grad_planes=grad_planes, tile=tile,
                              canvas_shape=canvas_shape)
    return _gather_bwd(None, motion, g, max_motion, False, grad_planes,
                       tile, canvas_shape,
                       counter=gather_canvas_bwd_hist_cuda)


gather_canvas_bwd_hist_cuda.launches = 0
gather_canvas_bwd_hist_cuda.scatter = LaunchCount()


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
    @spanned("rdt.temporal.bwd")
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
    @spanned("rdt.temporal.bwd")
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
    """The differentiable unbounded-motion step through
    :func:`reproject_clamped_cuda`, on the history stacked channel-minor
    by KGp on the card (planar, as the plain step stacks it, on the
    CPU)."""
    return temporal_step_clamped(
        gbuf, history, params, reproject_clamped_cuda,
        history_stack_channel_minor_cuda if gbuf.render.is_cuda
        else history_stack)


def temporal_bwd_cuda(gbuf: GBuffer, history: History, moments: torch.Tensor,
                      n_new: torch.Tensor, g_integrated, g_variance,
                      g_moments, *, params: SVGFParams) -> torch.Tensor:
    """K16: the render's cotangent of the bounded whole-frame step for the
    cotangents of its outputs (each may be None: zero), from the step's
    inputs and its outputs ``moments`` and ``n_new``, as
    ``ops.temporal.temporal_step_bwd_ref`` computes it (its plain twin,
    which CPU tensors run).  No gradient of its own.

    Each launch adds one to ``temporal_bwd_cuda.launches``."""
    _build.check_no_grad("temporal_bwd_cuda", gbuf.render, moments,
                         g_integrated, g_variance, g_moments)
    if not gbuf.render.is_cuda:
        return temporal_step_bwd_ref(gbuf, history, moments, n_new,
                                     g_integrated, g_variance, g_moments,
                                     params)
    if params.max_motion is None:
        raise ValueError("K16 requires SVGFParams.max_motion (bounded "
                         "reprojection)")
    H, W = gbuf.depth.shape
    dev = gbuf.device
    f32 = torch.float32
    motion = (gbuf.motion if gbuf.motion is not None
              else torch.zeros((2, H, W), dtype=f32, device=dev))
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (gbuf.render, "render", (3, H, W)), (motion, "motion", (2, H, W)),
        (gbuf.depth, "depth", (H, W)), (gbuf.normal, "normal", (3, H, W)),
        (history.color, "history.color", (3, H, W)),
        (history.length, "history.length", (H, W)),
        (history.prev_depth, "history.prev_depth", (H, W)),
        (history.prev_normal, "history.prev_normal", (3, H, W)),
        (moments, "moments", (2, H, W)), (n_new, "n_new", (H, W)))]
    # the cotangents, made contiguous and kept alive until the launch
    cot = [None if t is None else t.contiguous()
           for t in (g_integrated, g_variance, g_moments)]
    gs = [None if t is None else _build.check_input(t, n, s, f32, dev)
          for t, n, s in zip(cot, ("g_integrated", "g_variance",
                                   "g_moments"),
                             ((3, H, W), (H, W), (2, H, W)))]
    d_render = torch.empty((3, H, W), dtype=f32, device=dev)
    p = _TemporalParams(H=H, W=W, max_motion=params.max_motion,
                        history_clamp=int(params.history_clamp),
                        boost_frames=params.variance_boost_frames,
                        alpha=params.temporal_alpha,
                        alpha_m=params.temporal_moments_alpha)
    rc = _build.kernels().rdt_temporal_bwd(
        *ptrs, *gs, d_render.data_ptr(), ctypes.addressof(p), _stream(n_new))
    _build.check(rc, "rdt_temporal_bwd")
    temporal_bwd_cuda.launches += 1
    return d_render


temporal_bwd_cuda.launches = 0


class _FusedTemporalStep(torch.autograd.Function):
    """The bounded whole-frame step where the render alone takes a
    gradient: forward K3 (:func:`_launch_temporal`, counted on
    ``temporal_accumulate_cuda.launches``; the plain step on CPU tensors),
    backward K16 (:func:`temporal_bwd_cuda`).  Outputs integrated,
    variance, the new moments and the new length (no gradient)."""

    @staticmethod
    def forward(ctx, render, gbuf, history, params):
        count("temporal_fused", 1)
        gbuf = gbuf.replace(**{k: getattr(gbuf, k).contiguous() for k in (
            "render", "depth", "normal", "motion")
            if getattr(gbuf, k) is not None})
        history = History(**{f: getattr(history, f).contiguous() for f in (
            "color", "moments", "length", "prev_depth", "prev_normal")})
        if render.is_cuda:
            integ, var, nh = _launch_temporal(
                gbuf, (history.color, history.moments, history.length,
                       history.prev_depth, history.prev_normal),
                params=params, tile=None)
            temporal_accumulate_cuda.launches += 1
        else:
            integ, var, nh = temporal_accumulate(gbuf, history,
                                                 params=params)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(nh.length)
        ctx.save_for_backward(gbuf.render, nh.moments, nh.length)
        ctx.step = (gbuf, history, params)
        return integ, var, nh.moments, nh.length

    @staticmethod
    @spanned("rdt.temporal.bwd")
    def backward(ctx, g_integ, g_var, g_mom, _g_len):
        render, moments, n_new = ctx.saved_tensors
        gbuf, history, params = ctx.step
        d_render = temporal_bwd_cuda(gbuf.replace(render=render), history,
                                     moments, n_new, g_integ, g_var, g_mom,
                                     params=params)
        return d_render, None, None, None


def fused_step_route(gbuf: GBuffer, history: History, params: SVGFParams,
                     motion_grad: bool) -> bool:
    """Whether :func:`temporal_accumulate_ad_cuda` takes the fused route
    (``_FusedTemporalStep``): bounded motion, no history plane that
    requires grad, and no motion gradient (``motion_grad`` False, no
    motion, or motion that does not require grad)."""
    if params.max_motion is None or any(
            t.requires_grad for t in (history.color, history.moments,
                                      history.length, history.prev_depth,
                                      history.prev_normal)):
        return False
    return not (motion_grad and gbuf.motion is not None
                and gbuf.motion.requires_grad)


def temporal_accumulate_ad_cuda(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
    motion_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, History]:
    """The differentiable temporal step (``temporal_accumulate_pallas_ad``).
    Values as ``temporal_accumulate``; returns ``(integrated, variance,
    new_history)``.  Where :func:`fused_step_route` holds, K3 and its
    adjoint K16 (``_FusedTemporalStep``; the render's gradient only, which
    is all that is asked there); elsewhere the K4-K6 reprojection, then
    the plain epilogue.  With ``max_motion=None``: the clamped gather and
    its adjoint (:func:`reproject_clamped_cuda`), whose motion gradient
    flows wherever motion requires grad, as in ``temporal_accumulate_ad``.

    While spans record, each call adds one to the counter
    ``temporal_steps``, and the fused route one to ``temporal_fused``."""
    count("temporal_steps", 1)
    if fused_step_route(gbuf, history, params, motion_grad):
        integ, var, moments, n_new = _FusedTemporalStep.apply(
            gbuf.render, gbuf, history, params)
        return integ, var, History(color=integ, moments=moments,
                                   length=n_new, prev_depth=gbuf.depth,
                                   prev_normal=gbuf.normal)
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
