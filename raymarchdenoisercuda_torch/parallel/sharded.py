"""The sharded SVGF + raymarch pipeline (BASELINE config 5) over
``torch.distributed``.

Counterpart of ``raymarchdenoisercuda_tpu/parallel/sharded.py``, where
everything runs inside ``shard_map``: here every rank runs the ``*_local``
functions on its own tile of a ('data', 'y', 'x') mesh
(``parallel/mesh.py``), and the halo exchange (``parallel/halo.py``)
brings the neighbours' pixels.  Correctness contract, as in JAX: the same
results (up to float reassociation) as the single-device path for any mesh,
enforced by masks in GLOBAL coordinates, so a tap inside a neighbour
arrives through the halo and a tap outside the image is dropped like the
reference's ``inRange`` guard (src/filter.cu:37-38).

Differentiable: the halo exchange is an autograd Function whose backward
sends the halo cotangents back to their owners, and the kernels' adjoints
write the gradients of their canvas margins (K2's and K14's ``out_halo``,
K5c/K6c's whole canvas), so autograd of a tile's loss gives each rank the
gradient of the sum over all tiles at its pixels; replicated leaves (the
material table) sum their gradients with one ``all_reduce``.

Implementations (``impl``): ``"plain"`` is the JAX package's oracle path
(PyTorch ops on halo-exchanged tiles); ``"auto"`` runs the kernels' tile
forms (CUDA on the card, their plain twins on the CPU): the à-trous levels
K1/K1b/K2/K14 with a tile origin and the frame's bounds, the temporal step
K3 with an origin, K3b and K4c-K6c on the history canvas.  The canvas of
the TPU package (row bands, 128-lane padding) has no counterpart: a canvas
here is a tile plus a margin on every side.

Left out: ``parallel/scaling.py`` (weak scaling over device counts) and
``utils/tiling.py`` (TPU VMEM budgets).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..device import resolve_device
from ..gbuffer import GBuffer, History
from ..models.pipeline import TrainState
from ..models.svgf import demodulate, remodulate
from ..ops.atrous import atrous_level_ref, sigma_denominator
from ..ops.atrous_cuda import (atrous_level_bwd_cuda,
                               atrous_level_bwd_stored_cuda,
                               atrous_level_cuda, atrous_level_fwd_cuda)
from ..ops.common import Tile
from ..ops.raymarch import render_gbuffer_window
from ..ops.temporal import (GRAD_PLANES, N_HIST_PLANES, _in_bounds, _motion,
                            _temporal_epilogue, history_from_stack,
                            history_stack, reproject_gather)
from ..ops.temporal_cuda import (reproject_gather_cuda,
                                 temporal_accumulate_canvas_ad_cuda,
                                 temporal_accumulate_canvas_cuda,
                                 temporal_accumulate_cuda)
from .halo import exchange_halo2d, tile_origin
from .mesh import Mesh, shard_plane, tile_slices, unshard_plane

IMPLS = ("plain", "auto", "levels")
TEMPORAL_IMPLS = ("plain", "fused", "ad", "fused_canvas", "ad_canvas")
CANVAS_TEMPORALS = ("fused_canvas", "ad_canvas")
BWD_IMPLS = ("auto", "stored", "recompute", "none")


def _rows_cols(x, oy, ox, th, tw, h):
    """The (…, th, tw) window at offset (oy, ox) of a tile padded by h."""
    return x[..., h + oy:h + oy + th, h + ox:h + ox + tw]


def _global_iota(ry, cx, th, tw, device):
    gy = torch.arange(ry, ry + th, device=device)[:, None]
    gx = torch.arange(cx, cx + tw, device=device)[None, :]
    return gy, gx


# ---------------------------------------------------------------------------
# the spatial sweep on tiles
# ---------------------------------------------------------------------------

def atrous_level_local(color_p, var_p, normal_p, depth_p, sden, zgrad,
                       ry: int, cx: int, Hg: int, Wg: int, *, level: int,
                       params: SVGFParams):
    """One à-trous level on a halo-padded tile (pad >= r·2^level on both
    axes), the oracle math with global masks and detached weights, its
    gradient by autograd: ``ops.atrous.atrous_level_ref``'s tile form, with
    the tile's σ-denominator ``sden``.  Returns the tile's ``(color,
    variance)``."""
    return atrous_level_ref(color_p, var_p, normal_p, depth_p, zgrad,
                            level=level, params=params, sigma_denom=sden,
                            tile=Tile((ry, cx), (Hg, Wg)))


def _sigma_local(v, tile: Tile, mesh: Mesh, params: SVGFParams):
    """The σ-denominator of a level from the tile's detached variance: the
    3x3 blur (the JAX package's ``_variance_blur3x3_local``) on a 1-wide
    exchanged halo, renormalised over the taps inside the frame."""
    return sigma_denominator(exchange_halo2d(v.detach(), 1, mesh), params,
                             tile=tile, shape=tuple(v.shape))


def _zgrad_local(depth, ry, cx, Hg, Wg, mesh: Mesh):
    """Central-difference depth gradient with a 1-wide halo exchange,
    one-sided at the frame's borders."""
    dp = exchange_halo2d(depth, 1, mesh)
    th, tw = depth.shape
    gy, gx = _global_iota(ry, cx, th, tw, depth.device)
    up = _rows_cols(dp, -1, 0, th, tw, 1)
    dn = _rows_cols(dp, 1, 0, th, tw, 1)
    lf = _rows_cols(dp, 0, -1, th, tw, 1)
    rt = _rows_cols(dp, 0, 1, th, tw, 1)
    fwd_y, bwd_y = dn - depth, depth - up
    fwd_x, bwd_x = rt - depth, depth - lf
    dzdy = torch.where(gy == 0, fwd_y, torch.where(gy == Hg - 1, bwd_y,
                                                   0.5 * (fwd_y + bwd_y)))
    dzdx = torch.where(gx == 0, fwd_x, torch.where(gx == Wg - 1, bwd_x,
                                                   0.5 * (fwd_x + bwd_x)))
    return torch.stack([dzdy, dzdx])


class _TileLevel(torch.autograd.Function):
    """One à-trous level of a tile through the kernels' tile forms, its
    colour and variance canvases halo-padded by the level's reach h:
    forward K1 (σ fused; with ``bwd_impl="stored"`` storing bf16 weights)
    or, given σ, K1b; backward K2 or K14 writing the (th + 2h, tw + 2h)
    canvas gradients, which the exchange's adjoint routes to their
    owners.  Detached weights: normal and depth get no gradient."""

    @staticmethod
    def forward(ctx, c_p, v_p, normal_p, depth_p, zgrad, sden, tile, level,
                params, weight_math, bwd_impl):
        ctx.level, ctx.params, ctx.bwd_impl = level, params, bwd_impl
        ctx.tile = tile
        grad = any(ctx.needs_input_grad[:2])
        if sden is None:
            store = grad and bwd_impl == "stored"
            out = atrous_level_cuda(c_p, v_p, normal_p, depth_p, zgrad,
                                    level=level, params=params,
                                    weight_math=weight_math, store=store,
                                    tile=tile)
            if store:
                ctx.save_for_backward(*out[2:])
            return out[0], out[1]
        c, v, norm = atrous_level_fwd_cuda(c_p, v_p, normal_p, depth_p,
                                           zgrad, sden, level=level,
                                           params=params, tile=tile)
        ctx.save_for_backward(c_p, normal_p, depth_p, zgrad, sden, norm)
        return c, v

    @staticmethod
    def backward(ctx, gc, gv):
        params, level = ctx.params, ctx.level
        h = params.radius << level
        gc, gv = gc.contiguous(), gv.contiguous()
        if ctx.bwd_impl == "none":
            raise RuntimeError("sharded spatial bwd_impl='none' is "
                               "inference-only; use 'stored' for training")
        if ctx.bwd_impl == "stored":
            w, norm = ctx.saved_tensors
            dc, dv = atrous_level_bwd_stored_cuda(
                w, norm, gc, gv, level=level, radius=params.radius,
                out_halo=h)
        else:
            c_p, normal_p, depth_p, zgrad, sden, norm = ctx.saved_tensors
            dc, dv = atrous_level_bwd_cuda(
                c_p, normal_p, depth_p, zgrad, sden, norm, gc, gv,
                level=level, params=params, tile=ctx.tile, out_halo=h)
        return (dc, dv) + (None,) * 9


def svgf_spatial_local(color, variance, normal, depth, Hg: int, Wg: int, *,
                       mesh: Mesh, params: SVGFParams,
                       return_feedback: bool = False, impl: str = "plain",
                       weight_math: str = "exact", bwd_impl: str = "auto"):
    """Multi-level à-trous on this rank's tile of an Hg x Wg image.

    ``impl="auto"`` runs the chained kernel sweep
    (:func:`svgf_spatial_chained_local`) when the deepest level's halo fits
    the tile, else the per-level kernel path (``"levels"``: K1b forward
    with σ from the exchanged blur, K14 backward, guidance exchanged per
    level, multi-hop where the halo exceeds the tile); ``"plain"`` is the
    oracle path.  ``bwd_impl="auto"``: ``"stored"`` with luma-only levels
    (the weight-agnostic adjoint), else ``"recompute"``.  Returns ``(c,
    v)`` or ``(c, v, feedback)`` of the tile."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl: {bwd_impl!r}")
    th, tw = depth.shape
    if params.pyramid_from is not None:
        raise NotImplementedError(
            "pyramid_from is an unsharded plain-path experiment only")
    if bwd_impl == "auto":
        bwd_impl = ("stored" if params.luma_only_from is not None
                    else "recompute")
    if impl == "auto":
        hmax = params.radius << max(params.iterations - 1, 0)
        if hmax <= min(th, tw):
            return svgf_spatial_chained_local(
                color, variance, normal, depth, Hg, Wg, mesh=mesh,
                params=params, return_feedback=return_feedback,
                weight_math=weight_math, bwd_impl=bwd_impl)
        impl = "levels"
    if params.luma_only_from is not None and impl == "levels":
        # the per-level kernels (the multi-hop halo > tile path) have no
        # luma-only forward/adjoint pair, as in the JAX package
        raise NotImplementedError(
            "luma_only_from on the sharded path requires the chained "
            "kernels (deepest halo <= tile; here halo "
            f"{params.radius << max(params.iterations - 1, 0)} > tile "
            f"({th}, {tw})) or impl='plain'")
    ry, cx = tile_origin((th, tw), mesh)
    tile = Tile((ry, cx), (Hg, Wg))
    normal, depth = normal.detach(), depth.detach()
    zgrad = _zgrad_local(depth, ry, cx, Hg, Wg, mesh)
    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        h = params.radius << lvl
        sden = _sigma_local(v, tile, mesh, params)
        if impl == "levels":
            c, v = _TileLevel.apply(
                exchange_halo2d(c, h, mesh), exchange_halo2d(v, h, mesh),
                exchange_halo2d(normal, h, mesh),
                exchange_halo2d(depth, h, mesh), zgrad, sden, tile, lvl,
                params, "exact", "recompute")
        else:
            c, v = atrous_level_local(
                exchange_halo2d(c, h, mesh), exchange_halo2d(v, h, mesh),
                exchange_halo2d(normal, h, mesh),
                exchange_halo2d(depth, h, mesh), sden, zgrad, ry, cx, Hg,
                Wg, level=lvl, params=params)
        if lvl + 1 == params.feedback_level:
            feedback = c
    return (c, v, feedback) if return_feedback else (c, v)


def svgf_spatial_chained_local(color, variance, normal, depth, Hg: int,
                               Wg: int, *, mesh: Mesh, params: SVGFParams,
                               return_feedback: bool = False,
                               weight_math: str = "exact",
                               bwd_impl: str = "recompute"):
    """The chained kernel sweep on this rank's tile: the guidance planes
    (normal, depth) are exchanged once, at the deepest level's halo M, and
    each level reads the h-wide band of them it needs as a view; colour
    and variance get an h-wide exchange per level (the JAX package's
    margin refresh).  ``bwd_impl``: ``"stored"`` (K1 storing bf16 weights,
    σ fused; K2 writing the margin gradients), ``"none"`` (K1, inference)
    or ``"recompute"`` (σ from the exchanged blur, K1b; K14 writing the
    margin gradients).  ``weight_math="fast"`` needs ``"stored"`` or
    ``"none"``, as in the unsharded sweep."""
    if bwd_impl not in ("stored", "recompute", "none"):
        raise ValueError(f"unknown bwd_impl: {bwd_impl!r}")
    if params.luma_only_from is not None and bwd_impl == "recompute":
        # the recompute adjoint re-derives FULL weights and would not match
        # a luma-only forward
        raise ValueError(
            "luma_only_from on the sharded chained path requires "
            "bwd_impl='stored' (or the inference-only 'none')")
    if weight_math == "fast" and bwd_impl == "recompute":
        raise ValueError("weight_math='fast' requires a stored bwd_impl")
    th, tw = depth.shape
    ry, cx = tile_origin((th, tw), mesh)
    tile = Tile((ry, cx), (Hg, Wg))
    M = params.radius << max(params.iterations - 1, 0)
    normal, depth = normal.detach(), depth.detach()
    normal_c = exchange_halo2d(normal, M, mesh)
    depth_c = exchange_halo2d(depth, M, mesh)
    zgrad = _zgrad_local(depth, ry, cx, Hg, Wg, mesh)
    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        h = params.radius << lvl
        band = (slice(M - h, M + th + h), slice(M - h, M + tw + h))
        sden = (None if bwd_impl != "recompute"
                else _sigma_local(v, tile, mesh, params))
        c, v = _TileLevel.apply(
            exchange_halo2d(c, h, mesh), exchange_halo2d(v, h, mesh),
            normal_c[(slice(None),) + band], depth_c[band], zgrad, sden,
            tile, lvl, params, weight_math, bwd_impl)
        if lvl + 1 == params.feedback_level:
            feedback = c
    return (c, v, feedback) if return_feedback else (c, v)


class _Shard(torch.autograd.Function):
    """This rank's tile of a replicated global plane; the backward gathers
    the tiles' gradients, so every rank gets the global gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return shard_plane(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return unshard_plane(ctx.mesh, g), None


class _Unshard(torch.autograd.Function):
    """The global plane from every rank's tile; the backward takes this
    rank's tile of the (replicated) global cotangent."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return unshard_plane(mesh, t)

    @staticmethod
    def backward(ctx, g):
        return shard_plane(ctx.mesh, g), None


def svgf_spatial_sharded(color, variance, normal, depth, *, mesh: Mesh,
                         params: SVGFParams = SVGFParams(),
                         return_feedback: bool = False, impl: str = "plain",
                         weight_math: str = "exact", bwd_impl: str = "auto"):
    """The sharded multi-level sweep of replicated global planes over the
    mesh's ('y', 'x') tiles; returns the global planes (on every rank of a
    data slice), differentiable as a function of global planes.

    Non-divisible shapes are padded to the mesh and masked: the tiles'
    global masks test the TRUE bounds, so every tap past the real border
    is dropped as in the unsharded sweep, and the padding is cropped from
    the outputs."""
    Hg, Wg = depth.shape
    _, ny, nx = mesh.shape
    Hp, Wp = -(-Hg // ny) * ny, -(-Wg // nx) * nx

    def tile(x):
        if (Hp, Wp) != (Hg, Wg):
            x = torch.nn.functional.pad(x, (0, Wp - Wg, 0, Hp - Hg))
        return _Shard.apply(x, mesh)

    outs = svgf_spatial_local(
        tile(color), tile(variance), tile(normal), tile(depth), Hg, Wg,
        mesh=mesh, params=params, return_feedback=return_feedback,
        impl=impl, weight_math=weight_math, bwd_impl=bwd_impl)
    return tuple(_Unshard.apply(o, mesh)[..., :Hg, :Wg] for o in outs)


# ---------------------------------------------------------------------------
# the temporal step on tiles
# ---------------------------------------------------------------------------

def _require_bounded(params: SVGFParams) -> int:
    if params.max_motion is None:
        raise ValueError(
            "sharded temporal accumulation requires bounded motion "
            "(SVGFParams.max_motion is None); unbounded reprojection "
            "cannot be halo-exchanged")
    return params.max_motion + 1     # halo: accepted motion + the tent's tap


def temporal_accumulate_local(gbuf: GBuffer, history: History, Hg: int,
                              Wg: int, *, mesh: Mesh, params: SVGFParams,
                              impl: str = "plain", motion_grad: bool = True):
    """The temporal step of this rank's tile (a History carry).

    ``impl``: ``"plain"`` (the reprojection and epilogue in PyTorch,
    differentiable), ``"fused"`` (K3 with the tile's origin on the
    halo-exchanged history and render: inference only), ``"ad"`` (the
    differentiable K4-K6 on the halo-exchanged tile as an image, the
    epilogue in PyTorch).  The history is read through a halo of
    max_motion + 1 pixels; a larger motion is a disocclusion, as on the
    single device.  Returns the tile's ``(integrated, variance,
    new_history)``."""
    mh = _require_bounded(params)
    th, tw = gbuf.depth.shape
    tile = Tile(tile_origin((th, tw), mesh), (Hg, Wg))
    motion = _motion(gbuf)
    work = gbuf.replace(render=exchange_halo2d(gbuf.render, 3, mesh),
                        motion=motion)
    if impl == "fused":
        hist_p = History(*(exchange_halo2d(getattr(history, f.name), mh,
                                           mesh)
                           for f in dataclasses.fields(History)))
        return temporal_accumulate_cuda(work, hist_p, params=params,
                                        tile=tile)
    if impl not in ("plain", "ad"):
        raise ValueError(f"unknown temporal impl: {impl!r}")
    gather, planes = ((reproject_gather, N_HIST_PLANES) if impl == "plain"
                      else (reproject_gather_cuda, GRAD_PLANES))
    g = gather(exchange_halo2d(history_stack(history), mh, mesh),
               exchange_halo2d(motion, mh, mesh), params.max_motion,
               motion_grad=motion_grad, grad_planes=planes)
    g = _rows_cols(g, 0, 0, th, tw, mh)
    gathered = (g[0:3], g[3:5], g[5], g[6], g[7:10])
    return _temporal_epilogue(work, gathered,
                              _in_bounds(motion, params.max_motion, tile),
                              params, tile)


def init_history_canvas(mesh: Mesh, Hg: int, Wg: int, params: SVGFParams, *,
                        device=None) -> torch.Tensor:
    """This rank's zero history canvas for the canvas temporal paths: (10,
    th + 2·mh, tw + 2·mh), mh = max_motion + 1, planes in the order colour
    3, moments 2, length, previous depth, previous normal 3.  ``device``
    defaults to the CUDA card (see ``device.resolve_device``)."""
    _, ny, nx = mesh.shape
    if Hg % ny or Wg % nx:
        raise ValueError(
            f"canvas-form temporal history requires a mesh-divisible global "
            f"shape: ({Hg}, {Wg}) does not tile over the ({ny}, {nx}) "
            f"('y','x') mesh; pad the image or use a History carry "
            f"(temporal_impl='plain', 'fused' or 'ad')")
    mh = _require_bounded(params)
    return torch.zeros((N_HIST_PLANES, Hg // ny + 2 * mh,
                        Wg // nx + 2 * mh), dtype=torch.float32,
                       device=resolve_device(device))


def history_from_canvas(canvas: torch.Tensor, th: int, tw: int,
                        params: SVGFParams) -> History:
    """The tile's History (views of the canvas's centre)."""
    mh = _require_bounded(params)
    return history_from_stack(_rows_cols(canvas, 0, 0, th, tw, mh))


def _canvas_from_history(history: History, mh: int) -> torch.Tensor:
    """A new canvas holding ``history`` in its centre and zeros in its
    margins (refreshed when the next frame consumes it)."""
    th, tw = history.length.shape
    out = history.length.new_zeros((N_HIST_PLANES, th + 2 * mh,
                                    tw + 2 * mh))
    out[:, mh:mh + th, mh:mh + tw] = history_stack(history)
    return out


def _refresh_margins(canvas: torch.Tensor, mh: int, mesh: Mesh):
    """The canvas with its margins holding the neighbours' current
    centres (an exchange of the centre).  On a mesh of one tile the
    margins lie outside the frame, where no kernel reads: the canvas is
    used as it is."""
    if mesh.shape[1] == mesh.shape[2] == 1:
        return canvas
    th, tw = canvas.shape[-2] - 2 * mh, canvas.shape[-1] - 2 * mh
    return exchange_halo2d(_rows_cols(canvas, 0, 0, th, tw, mh), mh, mesh)


def temporal_accumulate_canvas_local(gbuf: GBuffer, canvas: torch.Tensor,
                                     Hg: int, Wg: int, *, mesh: Mesh,
                                     params: SVGFParams,
                                     motion_grad: bool = True):
    """The differentiable temporal step of the tile on its history canvas
    (K4c; K5c, or K6c without ``motion_grad``, in the backward): the
    margins are refreshed from the neighbours, and the adjoint's margin
    gradients go back to them through the exchange.  Returns
    ``(integrated, variance, new_canvas)``."""
    mh = _require_bounded(params)
    th, tw = gbuf.depth.shape
    tile = Tile(tile_origin((th, tw), mesh), (Hg, Wg))
    work = gbuf.replace(render=exchange_halo2d(gbuf.render, 3, mesh),
                        motion=_motion(gbuf))
    integ, var, new_h = temporal_accumulate_canvas_ad_cuda(
        work, _refresh_margins(canvas, mh, mesh), params=params, tile=tile,
        motion_grad=motion_grad)
    return integ, var, _canvas_from_history(new_h, mh)


def temporal_accumulate_canvas_fused_local(gbuf: GBuffer,
                                           canvas: torch.Tensor, Hg: int,
                                           Wg: int, *, mesh: Mesh,
                                           params: SVGFParams):
    """The inference twin of :func:`temporal_accumulate_canvas_local`: K3b
    on the history canvas and a 3-wide exchanged render ring (the 7x7
    window's and the 3x3 clamp's reach); motion, depth and normal are read
    at the tile's pixels only.  Returns ``(integrated, variance,
    new_canvas)``."""
    mh = _require_bounded(params)
    th, tw = gbuf.depth.shape
    tile = Tile(tile_origin((th, tw), mesh), (Hg, Wg))
    work = gbuf.replace(render=exchange_halo2d(gbuf.render, 3, mesh),
                        motion=_motion(gbuf))
    integ, var, new_h = temporal_accumulate_canvas_cuda(
        work, _refresh_margins(canvas, mh, mesh), params=params, tile=tile)
    return integ, var, _canvas_from_history(new_h, mh)


# ---------------------------------------------------------------------------
# the pipeline: render -> temporal -> spatial, sharded end to end
# ---------------------------------------------------------------------------

def fold_in(generator: torch.Generator, k: int) -> torch.Generator:
    """A generator seeded from ``generator``'s next draw and ``k`` (the
    counterpart of ``jax.random.fold_in``): ranks that hold copies of one
    generator draw independent light samples, and each copy advances
    alike."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(generator.device).manual_seed(
        (seed + (k + 1) * 0x9E3779B97F4A7C15) % 2 ** 63)


def _check_history_carry(history, temporal_impl: str) -> None:
    """A targeted error for a History carry on a canvas path, and back."""
    canvas = temporal_impl in CANVAS_TEMPORALS
    if canvas and isinstance(history, History):
        raise TypeError(
            f"temporal_impl={temporal_impl!r} carries the temporal history "
            f"as a margin CANVAS tensor, but a History was passed; build the "
            f"carry with init_history_canvas(mesh, Hg, Wg, params)")
    if not canvas and not isinstance(history, History):
        raise TypeError(
            f"temporal_impl={temporal_impl!r} expects a History carry, got "
            f"{type(history).__name__}; use History.zeros(th, tw) "
            f"(init_history_canvas is for the canvas temporal paths)")


def pipeline_local(scene, camera, prev_camera, history, Hg: int, Wg: int, *,
                   mesh: Mesh, cam_cfg: CameraParams,
                   rm_params: RaymarchParams, svgf_params: SVGFParams,
                   generator: Optional[torch.Generator] = None,
                   light_sample: Optional[torch.Tensor] = None, spp: int = 1,
                   demod: bool = True, impl: str = "plain",
                   temporal_impl: str = "plain", weight_math: str = "exact",
                   spatial_bwd_impl: str = "auto", motion_grad: bool = True):
    """This rank's frame: render its window of the image, the temporal
    step, the sweep; returns the tile's ``(gbuffer with denoised,
    new_history)`` (a canvas on the canvas temporal paths).

    The render needs no exchange (each rank marches its own pixels; with
    ``rm_params.coarse_seed`` it seeds them from the camera at its window
    origin);
    ``light_sample`` is the GLOBAL sample, of which the rank takes its
    window (tests pass the JAX package's), else ``generator`` folded with
    the rank's tile index draws it.  ``impl`` ("plain" or "auto") picks the
    renderer's and the sweep's implementation; ``temporal_impl`` one of
    ``TEMPORAL_IMPLS``; ``spatial_bwd_impl="auto"`` is ``"none"`` after a
    fused (gradient-free) temporal step, else ``"stored"`` with luma-only
    levels, else ``"recompute"``."""
    if temporal_impl not in TEMPORAL_IMPLS:
        raise ValueError(f"unknown temporal_impl: {temporal_impl!r}")
    if spatial_bwd_impl == "auto":
        if temporal_impl in ("fused", "fused_canvas"):
            spatial_bwd_impl = "none"
        elif svgf_params.luma_only_from is not None:
            spatial_bwd_impl = "stored"
        else:
            spatial_bwd_impl = "recompute"
    d, ny, nx = mesh.shape
    th, tw = Hg // ny, Wg // nx
    ry, cx = tile_origin((th, tw), mesh)
    if light_sample is not None:
        rows, cols = tile_slices(mesh, th, tw)
        light_sample = light_sample[..., rows, cols]
    elif generator is not None:
        generator = fold_in(generator, mesh.coords[1] * nx + mesh.coords[2])
    gbuf = render_gbuffer_window(
        scene, camera, prev_camera, generator, ry, cx, th, tw,
        cam_cfg=cam_cfg, params=rm_params, light_sample=light_sample,
        spp=spp, impl="plain" if impl == "plain" else "auto")

    work = (gbuf.replace(render=demodulate(gbuf.render, gbuf.albedo))
            if demod else gbuf)
    kw = dict(mesh=mesh, params=svgf_params)
    if temporal_impl == "fused_canvas":
        integrated, variance, new_history = (
            temporal_accumulate_canvas_fused_local(work, history, Hg, Wg,
                                                   **kw))
    elif temporal_impl == "ad_canvas":
        integrated, variance, new_history = temporal_accumulate_canvas_local(
            work, history, Hg, Wg, motion_grad=motion_grad, **kw)
    else:
        integrated, variance, new_history = temporal_accumulate_local(
            work, history, Hg, Wg, impl=temporal_impl,
            motion_grad=motion_grad, **kw)
    filtered, _v, feedback = svgf_spatial_local(
        integrated, variance, gbuf.normal, gbuf.depth, Hg, Wg,
        return_feedback=True, impl=impl, weight_math=weight_math,
        bwd_impl=spatial_bwd_impl, **kw)
    if temporal_impl in CANVAS_TEMPORALS:
        # the feedback level replaces the history colour in the canvas's
        # centre (its margins are refreshed when the next frame reads it)
        mh = svgf_params.max_motion + 1
        new_history[0:3, mh:mh + th, mh:mh + tw] = feedback
    else:
        new_history = new_history.replace(color=feedback)
    denoised = remodulate(filtered, gbuf.albedo) if demod else filtered
    return gbuf.replace(denoised=denoised), new_history


def _default_temporal(impl: str, training: bool) -> str:
    if impl == "plain":
        return "plain"
    return "ad_canvas" if training else "fused_canvas"


def make_sharded_pipeline(mesh: Mesh, Hg: int, Wg: int, *,
                          cam_cfg: CameraParams, rm_params: RaymarchParams,
                          svgf_params: SVGFParams, spp: int = 1,
                          impl: str = "auto", temporal_impl: str = "auto",
                          weight_math: str = "exact"):
    """The sharded serving frame function (no gradient):
    ``run(scene, camera, prev_camera, history, generator=None,
    light_sample=None) -> (tile gbuffer, new_history)``.

    ``temporal_impl="auto"``: with the kernels (``impl="auto"``), K3b on
    the margin canvas (``"fused_canvas"``; the carry comes from
    :func:`init_history_canvas`, and a frame exchanges the canvas's
    margins and a 3-wide render ring only); ``"fused"`` keeps the
    full-exchange K3 tile path (a History carry)."""
    if temporal_impl == "auto":
        temporal_impl = _default_temporal(impl, training=False)

    @torch.no_grad()
    def run(scene, camera, prev_camera, history, generator=None,
            light_sample=None):
        _check_history_carry(history, temporal_impl)
        return pipeline_local(
            scene, camera, prev_camera, history, Hg, Wg, mesh=mesh,
            cam_cfg=cam_cfg, rm_params=rm_params, svgf_params=svgf_params,
            generator=generator, light_sample=light_sample, spp=spp,
            impl=impl, temporal_impl=temporal_impl, weight_math=weight_math)

    return run


def init_sharded_train_state(mesh: Mesh, albedo_init: torch.Tensor, Hg: int,
                             Wg: int, params: SVGFParams,
                             generator: Optional[torch.Generator] = None, *,
                             impl: str = "auto", temporal_impl: str = "auto",
                             lr: float = 1e-2) -> TrainState:
    """A fresh sharded training state (``models.pipeline.init_train_state``
    with this rank's history carry: a canvas on the canvas temporal
    paths, else the tile's History); every rank holds the same albedo,
    optimizer and generator."""
    if temporal_impl == "auto":
        temporal_impl = _default_temporal(impl, training=True)
    albedo = albedo_init.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([albedo], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if temporal_impl in CANVAS_TEMPORALS:
        history = init_history_canvas(mesh, Hg, Wg, params,
                                      device=albedo.device)
    else:
        _, ny, nx = mesh.shape
        history = History.zeros(Hg // ny, Wg // nx, device=albedo.device)
    return TrainState(albedo, opt, history, generator)


def _detached(history):
    if isinstance(history, torch.Tensor):
        return history.detach()
    return History(*(getattr(history, f.name).detach()
                     for f in dataclasses.fields(History)))


def make_sharded_train_step(mesh: Mesh, base_scene, camera,
                            target: torch.Tensor, *, cam_cfg: CameraParams,
                            rm_params: RaymarchParams,
                            svgf_params: SVGFParams, impl: str = "auto",
                            temporal_impl: str = "auto",
                            spatial_bwd_impl: str = "auto"):
    """The sharded training step of ``models.pipeline.make_train_step``
    (BASELINE config 5 on config 4's loss): each rank renders and denoises
    its tile with ``motion_grad=False`` (material-only training); the loss,
    ``mean((denoised − target)²)`` over the image, is the sum of the tiles'
    sums over all ranks, divided by the pixel count and by the ``data``
    extent (each data slice renders its own Monte-Carlo sample with its own
    history, so the gradient averages them); the replicated albedo's
    gradient is ``all_reduce``d, and every rank takes the same Adam step.

    ``target`` is the global (3, Hg, Wg) image.  ``temporal_impl="auto"``:
    K4c on the history canvas with the kernels, the plain step otherwise;
    ``spatial_bwd_impl="auto"``: the stored-weight adjoint with the
    kernels (K1 store, K2 writing the margin gradients), else recompute.
    Only the albedo is differentiated, as in the JAX package: the history
    carry is a constant of the step, so the gather's adjoint (K5c/K6c)
    does not run.

    ``train_step(state, light_sample=None) -> (state, loss)``, ``state``
    from :func:`init_sharded_train_state`; ``light_sample`` the global
    sample (the tests pass the JAX package's)."""
    if temporal_impl == "auto":
        temporal_impl = _default_temporal(impl, training=True)
    if spatial_bwd_impl == "auto":
        spatial_bwd_impl = "stored" if impl == "auto" else "recompute"
    Hg, Wg = target.shape[-2:]
    nd = mesh.shape[0]
    target_tile = shard_plane(mesh, target)

    def train_step(state: TrainState,
                   light_sample: Optional[torch.Tensor] = None):
        _check_history_carry(state.history, temporal_impl)
        state.optimizer.zero_grad(set_to_none=True)
        scene = dataclasses.replace(base_scene, materials=dataclasses.replace(
            base_scene.materials, albedo=state.albedo))
        gen = state.generator
        if gen is not None and nd > 1:
            gen = fold_in(gen, mesh.coords[0])
        out, new_hist = pipeline_local(
            scene, camera, None, state.history, Hg, Wg, mesh=mesh,
            cam_cfg=cam_cfg, rm_params=rm_params, svgf_params=svgf_params,
            generator=gen, light_sample=light_sample, impl=impl,
            temporal_impl=temporal_impl, spatial_bwd_impl=spatial_bwd_impl,
            # material-only optimisation: the motion gradient is dead
            motion_grad=False)
        loss = ((out.denoised - target_tile) ** 2).sum() / (3 * Hg * Wg * nd)
        loss.backward()
        loss = loss.detach()
        if state.albedo.grad is None:
            state.albedo.grad = torch.zeros_like(state.albedo)
        if mesh.distributed:
            dist.all_reduce(state.albedo.grad)
            dist.all_reduce(loss)
        state.optimizer.step()
        with torch.no_grad():
            state.albedo.clamp_(0.0, 1.0)
        return state._replace(history=_detached(new_hist)), loss

    return train_step
