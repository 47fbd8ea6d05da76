"""SDF raymarcher emitting a full G-buffer: scene model, camera, the plain
PyTorch march and shading, and ``render_gbuffer``.

Counterpart of ``raymarchdenoisercuda_tpu/ops/raymarch.py``.  The plain
functions ``march_gbuf``, ``shadow_shade``, ``shadow_factor`` and
``cone_march`` are the CPU path and the oracles of the CUDA kernels K7, K8,
K13 and K15 (``ops/cuda/raymarch.cu``); on the card ``render_gbuffer`` goes
through the kernels (``ops/raymarch_cuda.py``).  The cone seed's glue
(``cone_rays`` from ray planes, ``cone_rays_analytic`` from the camera) is
PyTorch; on the card K15 builds the camera's cones itself, with the glue's
floats, and only the ray-plane route runs ``cone_rays``.  The scene and
camera constructors
create their tensors on the CUDA card unless given ``device``.

Gradients: the material tables, the light sample and the light reach the
render through the shading (:func:`shade_epilogue`, differentiated by
autograd, and on the card by K8's backward, which recomputes it); the
visibility is piecewise constant.  The hit distance reaches the scene's
primitives and the rays through the march's implicit-function adjoint
(:func:`raymarch`, the JAX package's ``raymarch`` with ``_raymarch_bwd``):
one SDF evaluation at the hit point, not autograd through the loop.  The
normal is differentiated by autograd of :func:`sdf_normal` at the hit
point, or, where the march emitted it fused (K7), by recomputing that
chain in the backward (``_gbuf_fused_bwd`` in the JAX package).  The SDF's
kinks take JAX's derivatives: d|x|/dx = +1 at 0, and ``max``/``min`` ties
split evenly; a norm's derivative at 0 is 0, where JAX's is NaN.

Per pixel: sphere-trace the primary ray (``max_steps``), take the material
of the nearest primitive at the hit (first primitive on ties, in the order
spheres, boxes, planes), central-difference normal flipped toward the
viewer; march one shadow ray to each of ``spp`` samples on the rectangular
area light (origin offset 0.02·n, minimum step 0.01); shade
``albedo·(L·vis·geom/π + 0.08) + emission`` with the direct light averaged
over the samples; reproject the hit point into the previous camera for
motion vectors (true division).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CameraParams, RaymarchParams
from ..device import resolve_device
from ..gbuffer import GBuffer
from ..utils.timing import spanned

_AMBIENT = 0.08
_SHADOW_MIN_STEP = 0.01
_SHADOW_OFFSET = 0.02


@dataclasses.dataclass(frozen=True)
class Materials:
    albedo: torch.Tensor    # (M, 3)
    emission: torch.Tensor  # (M, 3)


@dataclasses.dataclass(frozen=True)
class Scene:
    """SDF primitive soup plus a rectangular area light."""

    sphere_params: torch.Tensor  # (Ns, 4): centre xyz, radius
    sphere_mat: torch.Tensor     # (Ns,) int32
    box_params: torch.Tensor     # (Nb, 6): centre xyz, half-extent xyz
    box_mat: torch.Tensor        # (Nb,) int32
    plane_params: torch.Tensor   # (Np, 4): unit normal xyz, offset (sdf = n.p + d)
    plane_mat: torch.Tensor      # (Np,) int32
    materials: Materials
    light_center: torch.Tensor   # (3,)
    light_u: torch.Tensor        # (3,) half-extent vector
    light_v: torch.Tensor        # (3,) half-extent vector
    light_radiance: torch.Tensor  # (3,)

    @property
    def device(self) -> torch.device:
        return self.sphere_params.device


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # (3,)
    look_at: torch.Tensor   # (3,)
    up: torch.Tensor        # (3,)


def _norm3_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


class _Norm3(torch.autograd.Function):
    """:func:`_norm3` with the derivative v/|v|, and 0 where |v| = 0.
    Autograd of the square root gives 0/0 there: a central-difference
    stencil point that lands exactly on a box's face (max(q, 0) = 0)
    turns every geometry gradient NaN (1080p Cornell frames have such
    pixels; the JAX package's ``jnp.linalg.norm`` gives NaN there too)."""

    @staticmethod
    def forward(ctx, v):
        r = _norm3_plain(v)
        ctx.save_for_backward(v, r)
        return r

    @staticmethod
    @spanned("rdt.render.bwd")
    def backward(ctx, g):
        v, r = ctx.saved_tensors
        scale = torch.where(r > 0, g / torch.where(r > 0, r, 1.0), 0.0)
        return v * scale[None]


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the leading axis of size 3 (explicit order)."""
    return _Norm3.apply(v) if v.requires_grad else _norm3_plain(v)


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(_norm3(v), min=eps)


def _dot3(v, w):
    return v[0] * w[0] + v[1] * w[1] + v[2] * w[2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


class _Abs(torch.autograd.Function):
    """|x| with JAX's derivative at the kink: +1 at x = 0 (and at -0.0),
    where ``torch.abs`` gives 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    @spanned("rdt.render.bwd")
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def sdf_scene(scene: Scene, p: torch.Tensor, want_mat: bool = True):
    """Signed distance (and material id) at points ``p`` (3, ...).  Its
    derivatives at the kinks are JAX's: ``_Abs``, ``maximum``/``minimum``
    against 0 and ``amax``/``amin`` split ties evenly."""
    sp = scene.sphere_params
    c = sp[:, :3].reshape(sp.shape[0], 3, *([1] * (p.dim() - 1)))
    d_sph = _norm3((p[None] - c).transpose(0, 1)) - sp[:, 3].reshape(
        -1, *([1] * (p.dim() - 1)))

    bp = scene.box_params
    cb = bp[:, :3].reshape(bp.shape[0], 3, *([1] * (p.dim() - 1)))
    hb = bp[:, 3:].reshape(bp.shape[0], 3, *([1] * (p.dim() - 1)))
    rel = p[None] - cb
    q = ((_Abs.apply(rel) if rel.requires_grad else torch.abs(rel))
         - hb).transpose(0, 1)                                 # (3, Nb, ...)
    zero = q.new_zeros(())
    d_box = _norm3(torch.maximum(q, zero)) + torch.minimum(
        torch.amax(q, 0), zero)

    pp = scene.plane_params
    shape = (-1,) + (1,) * (p.dim() - 1)
    d_pl = (pp[:, 0].reshape(shape) * p[0][None]
            + pp[:, 1].reshape(shape) * p[1][None]
            + pp[:, 2].reshape(shape) * p[2][None]
            + pp[:, 3].reshape(shape))

    dists = torch.cat([d_sph, d_box, d_pl], 0)
    if not want_mat:
        return torch.amin(dists, 0)
    mats = torch.cat([scene.sphere_mat, scene.box_mat, scene.plane_mat])
    d, idx = torch.min(dists, 0)   # first minimum on ties
    return d, mats[idx]


def sdf_normal(scene: Scene, p: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Central-difference SDF gradient -> unit normal (3, ...)."""
    def d(axis, sign):
        off = torch.zeros(3, dtype=p.dtype, device=p.device)
        off[axis] = sign * eps
        return sdf_scene(scene, p + off.reshape(3, *([1] * (p.dim() - 1))),
                         want_mat=False)

    n = torch.stack([d(0, 1) - d(0, -1), d(1, 1) - d(1, -1),
                     d(2, 1) - d(2, -1)])
    return _normalize(n)


def camera_basis(camera: Camera, cfg: CameraParams):
    """(fwd, right, up, half_w, half_h) of a pinhole camera."""
    fwd = _normalize(camera.look_at - camera.position)
    # screen-right = up x fwd: +x world appears on screen right
    right = _normalize(_cross(camera.up, fwd))
    up = _cross(fwd, right)
    # torch.full fills on the device; a tensor made from a Python number
    # is copied from the host, which waits for the stream on the card
    half_h = torch.tan(torch.full((), cfg.fov_y / 2.0, dtype=fwd.dtype,
                                  device=fwd.device))
    half_w = half_h * (cfg.width / cfg.height)
    return fwd, right, up, half_w, half_h


def camera_rays_window(camera: Camera, cfg: CameraParams,
                       row0: int, col0: int, th: int, tw: int):
    """Ray origins/directions (3, th, tw) for a pixel window at (row0, col0)."""
    H, W = cfg.height, cfg.width
    fwd, right, up, half_w, half_h = camera_basis(camera, cfg)
    dev, dt = fwd.device, fwd.dtype
    ys = (0.5 - (row0 + torch.arange(th, device=dev, dtype=dt) + 0.5) / H
          ) * 2 * half_h                                     # +y up
    xs = ((col0 + torch.arange(tw, device=dev, dtype=dt) + 0.5) / W - 0.5
          ) * 2 * half_w
    dirs = (fwd[:, None, None] + up[:, None, None] * ys[None, :, None]
            + right[:, None, None] * xs[None, None, :])
    rd = _normalize(dirs)
    ro = camera.position[:, None, None].expand_as(rd).contiguous()
    return ro, rd, (fwd, right, up, half_w, half_h)


def camera_rays(camera: Camera, cfg: CameraParams):
    """Primary ray origins/directions (3, H, W)."""
    return camera_rays_window(camera, cfg, 0, 0, cfg.height, cfg.width)


def _raymarch_loop(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                   params: RaymarchParams,
                   t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sphere-trace all rays in lock-step; returns t.  A ray that stops
    (converged or escaped) never moves again, so the loop ends as soon as no
    ray moved, with the result of running all ``max_steps``.

    ``t0``: each ray's start (the cone seed; default 0).  ``relax_omega >
    1``: over-relaxed tracing with rollback (a step whose end sphere does
    not overlap the start sphere goes back to the conservative step); it
    starts with no previous step at the seed too."""
    zero = torch.zeros(ro.shape[1:], dtype=ro.dtype, device=ro.device)
    t = zero if t0 is None else t0
    om = params.relax_omega
    if om <= 1.0:
        for _ in range(params.max_steps):
            d = sdf_scene(scene, ro + t[None] * rd, want_mat=False)
            active = (d > params.hit_eps) & (t < params.max_dist)
            if not bool(active.any()):
                break
            t = t + torch.where(active, d, zero)
        return t
    d_prev, step_prev = zero, zero
    for _ in range(params.max_steps):
        d = sdf_scene(scene, ro + t[None] * rd, want_mat=False)
        fail = ((d + d_prev) < step_prev) & (step_prev > d_prev)
        active = (d > params.hit_eps) & (t < params.max_dist) & ~fail
        if not bool((active | fail).any()):
            break
        delta = torch.where(fail, d_prev - step_prev,
                            torch.where(active, om * d, zero))
        new_step = torch.where(fail, d_prev,
                               torch.where(active, om * d, step_prev))
        d_prev = torch.where(active, d, d_prev)
        step_prev = new_step
        t = t + delta
    return t


# ---------------------------------------------------------------------------
# the cone pre-march seed (RaymarchParams.coarse_seed; kernel K15)
# ---------------------------------------------------------------------------

# one cone a SEED_BLOCK x SEED_BLOCK pixel block (_SEED_BLOCK of the JAX
# package's raymarch_tpu.py)
SEED_BLOCK = 4


def seed_grid_shape(H: int, W: int) -> Tuple[int, int]:
    """(Hc, Wc): the coarse grid of an H x W frame, one cell a block."""
    return -(-H // SEED_BLOCK), -(-W // SEED_BLOCK)


def _upsample_blocks(x: torch.Tensor) -> torch.Tensor:
    """Each cell of (..., Hc, Wc) repeated over its block."""
    B = SEED_BLOCK
    return x.repeat_interleave(B, -2).repeat_interleave(B, -1)


def seed_plane(t_c: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The (H, W) per-pixel seed: each pixel takes its block's stop (the
    nearest upsample of the coarse grid)."""
    return _upsample_blocks(t_c)[:H, :W]


def cone_rays(ro: torch.Tensor, rd: torch.Tensor):
    """The coarse cones of ray planes (3, H, W): ``(ro_c, rd_c, delta,
    base)``.  A block's apex is the mean of its origins and its axis the
    renormalised sum of its directions (the planes edge-replicated to whole
    blocks); ``delta`` and ``base`` are the GLOBAL maxima of each pixel's
    direction and origin deviation from its block's, 0-d tensors."""
    B = SEED_BLOCK
    H, W = ro.shape[-2:]
    Hc, Wc = seed_grid_shape(H, W)
    pad = (0, B * Wc - W, 0, B * Hc - H)
    rop = torch.nn.functional.pad(ro[None], pad, mode="replicate")[0]
    rdp = torch.nn.functional.pad(rd[None], pad, mode="replicate")[0]
    ro_c = rop.reshape(3, Hc, B, Wc, B).mean(dim=(2, 4))
    rd_sum = rdp.reshape(3, Hc, B, Wc, B).sum(dim=(2, 4))
    rd_c = rd_sum / torch.clamp(_norm3(rd_sum), min=1e-8)[None]

    def deviation(full, centre):
        diff = full - _upsample_blocks(centre)
        return torch.sqrt(torch.amax(_dot3(diff, diff)))

    return ro_c, rd_c, deviation(rdp, rd_c), deviation(rop, ro_c)


def rays_at_pixels(camera: Camera, cfg: CameraParams, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """Unit rays through (possibly fractional) GLOBAL pixel coordinates:
    ``rows`` (..., n) by ``cols`` (..., m) with the same leading shape ->
    (3, ..., n, m)."""
    fwd, right, up, half_w, half_h = camera_basis(camera, cfg)
    ys = (0.5 - (rows + 0.5) / cfg.height) * 2 * half_h
    xs = ((cols + 0.5) / cfg.width - 0.5) * 2 * half_w

    def vec(v):
        return v.reshape((3,) + (1,) * (ys.dim() + 1))

    dirs = (vec(fwd) + vec(up) * ys[None, ..., :, None]
            + vec(right) * xs[None, ..., None, :])
    return _normalize(dirs)


def cone_rays_analytic(camera: Camera, cfg: CameraParams, row0: int,
                       col0: int, th: int, tw: int):
    """The coarse cones of the th x tw window at GLOBAL pixel (row0, col0),
    straight from the camera: ``(ro_c, rd_c, delta, base)``.  Each block's
    axis is the ray through its centre pixel; ``base`` = 0 (one pinhole
    origin); ``delta`` is the largest deviation of a block's 4 corner
    pixels' rays from its axis (a ray's deviation grows with its offset on
    the screen, so the corners bound the block)."""
    B = SEED_BLOCK
    Hc, Wc = seed_grid_shape(th, tw)
    c = (B - 1) / 2.0
    dev, dt = camera.position.device, camera.position.dtype
    # block-centre pixel coordinates (small integers and halves: exact in
    # any order), made on the device
    rows = torch.arange(Hc, dtype=dt, device=dev) * B + (row0 + c)
    cols = torch.arange(Wc, dtype=dt, device=dev) * B + (col0 + c)
    # the centre, then the four corners (dy, dx) in (-c, c)^2
    rd5 = rays_at_pixels(
        camera, cfg, torch.stack([rows, rows - c, rows - c, rows + c,
                                  rows + c]),
        torch.stack([cols, cols - c, cols + c, cols - c, cols + c]))
    # rd5: (3, 5, Hc, Wc)
    rd_c = rd5[:, 0].contiguous()
    diff = rd5[:, 1:] - rd_c[:, None]
    delta = torch.sqrt(torch.amax(_dot3(diff, diff)))
    ro_c = camera.position[:, None, None].expand(3, Hc, Wc).contiguous()
    return ro_c, rd_c, delta, torch.zeros((), dtype=dt, device=dev)


def cone_march(scene: Scene, ro_c: torch.Tensor, rd_c: torch.Tensor,
               delta: torch.Tensor, base: torch.Tensor,
               params: RaymarchParams) -> torch.Tensor:
    """Plain version of K15: sphere-trace each cone against the fattened
    distance, margin = d − (hit_eps + base) − t·delta, with steps of
    margin / (1 + delta), until margin <= 0, t >= max_dist or max_steps;
    returns the (Hc, Wc) stops.  Along the marched segment sdf >= hit_eps +
    base + s·delta, so a stop is a skip-free start for every ray of its
    block."""
    zero = torch.zeros(ro_c.shape[1:], dtype=ro_c.dtype, device=ro_c.device)
    t = zero
    clear0 = params.hit_eps + base
    inv_g = 1.0 / (1.0 + delta)
    for _ in range(params.max_steps):
        d = sdf_scene(scene, ro_c + t[None] * rd_c, want_mat=False)
        margin = d - clear0 - t * delta
        active = (margin > 0.0) & (t < params.max_dist)
        if not bool(active.any()):
            break
        t = t + torch.where(active, margin * inv_g, zero)
    return t


def cone_seed_coarse(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                     params: RaymarchParams):
    """The coarse seed grid of ray planes (``_cone_seed_coarse`` of the JAX
    package, unpadded): ``(t_c, delta, base)``, t_c (Hc, Wc)."""
    ro_c, rd_c, delta, base = cone_rays(ro, rd)
    return cone_march(scene, ro_c, rd_c, delta, base, params), delta, base


def cone_seed_coarse_analytic(scene: Scene, camera: Camera,
                              cfg: CameraParams, row0: int, col0: int,
                              th: int, tw: int, params: RaymarchParams):
    """The coarse seed grid of a camera window
    (``_cone_seed_coarse_analytic`` of the JAX package, unpadded):
    ``(t_c, delta, base)``."""
    ro_c, rd_c, delta, base = cone_rays_analytic(camera, cfg, row0, col0,
                                                 th, tw)
    return cone_march(scene, ro_c, rd_c, delta, base, params), delta, base


def _march_plain(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                 params: RaymarchParams, t0: Optional[torch.Tensor],
                 normal: bool):
    """The plain march and its G-buffer epilogue without autograd: ``(t,
    hit, mat, n)``, ``n`` None unless ``normal``."""
    t = _raymarch_loop(scene, ro, rd, params, t0)
    p = ro + t[None] * rd
    d_final, mat = sdf_scene(scene, p)
    hit = (d_final <= params.hit_eps * 4.0) & (t < params.max_dist)
    n = _flipped_normal(scene, p, rd, params.normal_eps) if normal else None
    return t, hit, mat.to(torch.int32), n


def _flipped_normal(scene: Scene, p: torch.Tensor, rd: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The unit central-difference normal at ``p``, flipped toward the
    viewer."""
    n = sdf_normal(scene, p, eps)
    return torch.where(_dot3(n, rd)[None] > 0, -n, n)


class _March(torch.autograd.Function):
    """The primary march with the implicit-function adjoint of the hit
    distance (``raymarch``'s custom VJP in the JAX package).

    Forward (no autograd): ``launch()`` returns ``(t, hit, mat, n)`` (the
    plain march, or K7/K7s on the card); the outputs are ``(t, hit, mat)``,
    with ``n`` after them where ``fused`` (the normal emitted by the march
    itself).  Backward, in PyTorch on either device: at p = ro + t·rd,
    denom = ∇f·rd from one SDF evaluation (its magnitude clamped at 1e-2,
    sign kept), s = -g_t / denom on hits and 0 elsewhere, then d_scene =
    f_θᵀs, d_ro = ∇f·s and d_rd = t·∇f·s (``_raymarch_bwd``).  Where
    ``fused``, the normal chain is recomputed first and its hit-point
    cotangent d_p folded in: g_t += Σ d_p·rd, d_ro += d_p, d_rd += t·d_p
    (``_gbuf_fused_bwd``).  A march seed does not enter the adjoint; the
    material ids and the hit mask carry no gradient."""

    @staticmethod
    def forward(ctx, sphere_params, box_params, plane_params, ro, rd, scene,
                params, launch, fused):
        t, hit, mat, n = launch()
        ctx.save_for_backward(sphere_params, box_params, plane_params, ro,
                              rd, t, hit)
        ctx.scene, ctx.params, ctx.fused = scene, params, fused
        ctx.mark_non_differentiable(hit, mat)
        return (t, hit, mat, n) if fused else (t, hit, mat)

    @staticmethod
    @spanned("rdt.render.bwd")
    def backward(ctx, g_t, _g_hit, _g_mat, g_n=None):
        sph, box, pl, ro, rd, t, hit = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:5]):
            return (None,) * 9
        with torch.enable_grad():
            geo = [x.detach().requires_grad_() for x in (sph, box, pl)]
            scene = dataclasses.replace(ctx.scene, sphere_params=geo[0],
                                        box_params=geo[1],
                                        plane_params=geo[2])
            p = (ro + t[None] * rd).detach()
            d_geo, d_p = [0.0, 0.0, 0.0], None
            if ctx.fused:
                pn = p.clone().requires_grad_()
                n = _flipped_normal(scene, pn, rd, ctx.params.normal_eps)
                *d_geo, d_p = _grads(n, geo + [pn], g_n)
                g_t = g_t + _dot3(d_p, rd)
            pf = p.clone().requires_grad_()
            f = sdf_scene(scene, pf, want_mat=False)
            (grad_f,) = torch.autograd.grad(f, pf, torch.ones_like(f),
                                            retain_graph=True)
            denom = _dot3(grad_f, rd)
            lim = torch.full_like(denom, 1e-2)
            safe = torch.where(denom.abs() < 1e-2,
                               torch.where(denom < 0, -lim, lim), denom)
            s = torch.where(hit, -g_t / safe, torch.zeros_like(g_t))
            *d_scene, d_pt = _grads(f, geo + [pf], s)
        d_geo = [a + b for a, b in zip(d_scene, d_geo)]
        if d_p is not None:
            d_pt = d_pt + d_p
        d_ro, d_rd = d_pt, t[None] * d_pt
        need = ctx.needs_input_grad
        return tuple(g if nd else None for g, nd in zip(
            d_geo + [d_ro, d_rd], need[:5])) + (None,) * 4


def _grads(out, inputs, cot):
    """``torch.autograd.grad`` of ``out`` against ``cot``, zeros for inputs
    that ``out`` does not reach."""
    gs = torch.autograd.grad(out, inputs, cot, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, inputs)]


def march(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
          params: RaymarchParams, launch=None, fused: bool = False):
    """The differentiable march (:class:`_March`): ``launch()`` gives its
    forward's ``(t, hit, mat, n)`` (default: the plain march from 0);
    returns ``(t, hit, mat)``, and ``n`` after them where ``fused``."""
    if launch is None:
        def launch():
            return _march_plain(scene, ro, rd, params, None, fused)
    return _March.apply(scene.sphere_params, scene.box_params,
                        scene.plane_params, ro, rd, scene, params, launch,
                        fused)


def raymarch(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
             params: RaymarchParams):
    """``(t, hit)`` of the plain march, differentiable by the implicit-
    function adjoint: the JAX package's ``raymarch``."""
    t, hit, _mat = march(scene, ro, rd, params)
    return t, hit


def march_gbuf(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
               params: RaymarchParams, seed: Optional[torch.Tensor] = None):
    """Plain version of K7: the primary march plus its G-buffer epilogue.

    Returns ``(t, hit, mat, normal)``: hit distance, hit mask
    (``d <= 4·hit_eps`` and ``t < max_dist``), int32 material id at the
    final point, and the unit central-difference normal flipped toward the
    viewer (not masked by ``hit``).  ``seed``: the coarse (Hc, Wc) grid of
    cone stops; each pixel's march starts at its block's stop.

    Differentiable in the scene's geometry and the rays: ``t`` by the
    implicit-function adjoint, the normal by autograd of ``sdf_normal`` at
    p = ro + t·rd (the JAX package's jnp path; K7's form, the normal
    recomputed in the backward, is ``march(..., fused=True)``)."""
    H, W = ro.shape[-2:]
    t0 = None if seed is None else seed_plane(seed, H, W)

    def launch():
        return _march_plain(scene, ro, rd, params, t0, False)

    t, hit, mat = march(scene, ro, rd, params, launch)
    n = _flipped_normal(scene, ro + t[None] * rd, rd, params.normal_eps)
    return t, hit, mat, n


def light_constants(scene: Scene) -> torch.Tensor:
    """(7,) = light normal normalize(u×v), radiance, area 4|u×v|."""
    c = _cross(scene.light_u, scene.light_v)
    area = 4.0 * _norm3(c)
    return torch.cat([_normalize(c), scene.light_radiance, area[None]])


def prev_camera_constants(prev_camera: Camera, cfg: CameraParams) -> torch.Tensor:
    """(14,) = position, fwd, right, up, half_w, half_h of the previous
    camera (the motion reprojection's inputs)."""
    fwd, right, up, half_w, half_h = camera_basis(prev_camera, cfg)
    return torch.cat([prev_camera.position, fwd, right, up,
                      half_w[None], half_h[None]])


def shadow_shade(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                 light_p: torch.Tensor, albedo: torch.Tensor,
                 emission: torch.Tensor, hit: torch.Tensor,
                 light_consts: torch.Tensor,
                 prev_consts: Optional[torch.Tensor],
                 params: RaymarchParams, cam_wh: Tuple[int, int],
                 window: Tuple[int, int] = (0, 0)):
    """Plain version of K8: shadow ray, direct-light shading and motion.

    Returns ``(render, vis, motion)``; ``motion`` is None without
    ``prev_consts``.  Miss pixels get ``dist_l = 0`` (their visibility march
    is skipped, vis = 1); their albedo and emission are masked to zero, so
    their render is zero either way.  ``window``: the global pixel of the
    planes' (0, 0), against which the motion is taken."""
    # the visibility is piecewise constant (the JAX package's
    # stop_gradient): its march records no graph
    with torch.no_grad():
        origin, ld, dist_l = _shadow_ray(p, n, light_p)
        dist_l = torch.where(hit, dist_l, torch.zeros_like(dist_l))
        vis = _shadow_march(scene, origin, ld, dist_l, params)
    render, motion = shade_epilogue(p, n, light_p, albedo, emission, hit,
                                    vis, light_consts, prev_consts, cam_wh,
                                    window)
    return render, vis, motion


def _shadow_ray(p: torch.Tensor, n: torch.Tensor, light_p: torch.Tensor):
    """``(origin, direction, distance)`` of the shadow ray from ``p``
    (offset 0.02·n along the normal) to the light sample."""
    origin = p + _SHADOW_OFFSET * n
    to_l = light_p - origin
    dist_l = _norm3(to_l)
    return origin, to_l / torch.clamp(dist_l, min=1e-8)[None], dist_l


def _shadow_march(scene: Scene, origin: torch.Tensor, ld: torch.Tensor,
                  dist_l: torch.Tensor, params: RaymarchParams) -> torch.Tensor:
    """The shadow march of K8 and K13 (minimum step 0.01, relaxed branch
    for ``relax_omega > 1``); returns the visibility ``t ≥ dist_l − 0.03``
    as 0/1 floats.  The loop ends once no ray moves, with the result of
    running all ``shadow_steps``."""
    zero = torch.zeros_like(dist_l)
    t = zero
    om = params.relax_omega
    if om <= 1.0:
        for _ in range(params.shadow_steps):
            d = sdf_scene(scene, origin + t[None] * ld, want_mat=False)
            active = (d > params.hit_eps) & (t < dist_l - 0.02)
            if not bool(active.any()):
                break
            t = t + torch.where(active, torch.clamp(d, min=_SHADOW_MIN_STEP),
                                zero)
    else:
        # the conservative fallback step keeps the minimum-step floor
        d_prev, step_prev = zero, zero
        for _ in range(params.shadow_steps):
            d = sdf_scene(scene, origin + t[None] * ld, want_mat=False)
            cons = torch.clamp(d_prev, min=_SHADOW_MIN_STEP)
            fail = ((d + d_prev) < step_prev) & (step_prev > cons)
            active = (d > params.hit_eps) & (t < dist_l - 0.02) & ~fail
            if not bool((active | fail).any()):
                break
            step = torch.clamp(om * d, min=_SHADOW_MIN_STEP)
            delta = torch.where(fail, cons - step_prev,
                                torch.where(active, step, zero))
            new_step = torch.where(fail, cons,
                                   torch.where(active, step, step_prev))
            d_prev = torch.where(active, d, d_prev)
            step_prev = new_step
            t = t + delta
    return (t >= dist_l - 0.03).to(dist_l.dtype)


@torch.no_grad()
def shadow_factor(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                  light_p: torch.Tensor, params: RaymarchParams) -> torch.Tensor:
    """Plain version of K13: the (H, W) shadow-ray visibility alone (1 =
    unoccluded), ``_shadow_factor`` of the JAX package.  Every pixel is
    marched, misses included (no hit mask).  Visibility is piecewise
    constant, so it carries no gradient."""
    origin, ld, dist_l = _shadow_ray(p, n, light_p)
    return _shadow_march(scene, origin, ld, dist_l, params)


def direct_light(p: torch.Tensor, n: torch.Tensor, light_p: torch.Tensor,
                 vis: torch.Tensor, light_consts: torch.Tensor) -> torch.Tensor:
    """(3, H, W) irradiance ``L·vis·geom`` from ``p`` toward one light
    sample (before the division by π)."""
    s = light_p - p
    dist2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
    sd = s / torch.clamp(torch.sqrt(dist2), min=1e-8)[None]
    cos_s = torch.clamp(_dot3(n, sd), min=0.0)
    ln, rad, area = light_consts[0:3], light_consts[3:6], light_consts[6]
    cos_l = torch.abs(ln[0] * sd[0] + ln[1] * sd[1] + ln[2] * sd[2])
    geom = cos_s * cos_l * area / torch.clamp(dist2, min=1e-4)
    return rad[:, None, None] * (vis * geom)[None]


def shade_epilogue(p: torch.Tensor, n: torch.Tensor, light_p: torch.Tensor,
                   albedo: torch.Tensor, emission: torch.Tensor,
                   hit: torch.Tensor, vis: torch.Tensor,
                   light_consts: torch.Tensor,
                   prev_consts: Optional[torch.Tensor],
                   cam_wh: Tuple[int, int],
                   window: Tuple[int, int] = (0, 0)):
    """K8's epilogue at a given visibility: direct light from ``p`` toward
    the light sample, ``albedo·(L·vis·geom/π + 0.08) + emission``, and the
    motion into the previous camera (None without ``prev_consts``).
    Returns ``(render, motion)``.  The forward of ``shadow_shade`` and the
    backward of K8 (``_shade_xla`` in the JAX package) both run it."""
    irr = direct_light(p, n, light_p, vis, light_consts)
    render = albedo * (irr / math.pi + _AMBIENT) + emission
    return render, reprojection_motion(p, hit, prev_consts, cam_wh, window)


def reprojection_motion(p: torch.Tensor, hit: torch.Tensor,
                        prev_consts: Optional[torch.Tensor],
                        cam_wh: Tuple[int, int],
                        window: Tuple[int, int] = (0, 0)
                        ) -> Optional[torch.Tensor]:
    """(2, H, W) motion (dy, dx) in pixels of each hit point into the
    previous camera, zero at misses; None without ``prev_consts``.  The
    planes' pixel (0, 0) is the frame's pixel ``window``."""
    if prev_consts is None:
        return None
    ppos, pfwd, pright, pup = (prev_consts[0:3], prev_consts[3:6],
                               prev_consts[6:9], prev_consts[9:12])
    phw, phh = prev_consts[12], prev_consts[13]
    rel = p - ppos[:, None, None]
    z = _dot3(pfwd, rel)
    # true division: a reciprocal-multiply's 1-ulp noise at zero motion flips
    # the temporal step's in-bounds test at the image border
    x = _dot3(pright, rel) / torch.clamp(z, min=1e-6)
    y = _dot3(pup, rel) / torch.clamp(z, min=1e-6)
    W, H = cam_wh
    px = (x / phw * 0.5 + 0.5) * W - 0.5
    py = (0.5 - y / phh * 0.5) * H - 0.5
    row0, col0 = window
    iy = (row0 + torch.arange(p.shape[1], dtype=p.dtype,
                              device=p.device))[:, None]
    ix = (col0 + torch.arange(p.shape[2], dtype=p.dtype,
                              device=p.device))[None, :]
    hit_f = hit.to(p.dtype)
    return torch.stack([py - iy, px - ix]) * hit_f[None]


def sample_light(scene: Scene, generator: Optional[torch.Generator],
                 shape) -> torch.Tensor:
    """Uniform random point on the rectangular area light -> (3, H, W).

    ``generator`` lives on the scene's device.  Its numbers differ from
    ``jax.random``'s for any seed; tests pass the reference's sample in."""
    u = torch.rand((2,) + tuple(shape), generator=generator,
                   dtype=scene.light_center.dtype,
                   device=scene.device) * 2.0 - 1.0
    return (scene.light_center[:, None, None]
            + scene.light_u[:, None, None] * u[0][None]
            + scene.light_v[:, None, None] * u[1][None])


class _TableLookup(torch.autograd.Function):
    """``table[idx]`` for a flat index map, as (C, N) planes.  The backward
    sums the cotangent per row with one float32 matrix product against the
    one-hot index map.  Autograd of the gather would scatter the N pixels
    into the M rows with ``index_put_``, whose CUDA backward serialises the
    duplicates: 53 ms of a 1080p training step on an NVIDIA H100
    (``utils/profile.py``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.t()[:, idx]

    @staticmethod
    @spanned("rdt.render.bwd")
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(idx, ctx.rows).to(g.dtype)
        return (g @ onehot).t(), None


def _material_lookup(mat: torch.Tensor, *tables: torch.Tensor):
    """Per-pixel material-table lookup: ``tables[i]`` is (M, C); returns one
    (C, H, W) plane stack per table."""
    idx = mat.long().reshape(-1)
    outs = [_TableLookup.apply(t, idx).reshape((t.shape[1],) + mat.shape)
            for t in tables]
    return outs if len(outs) > 1 else outs[0]


def render_gbuffer(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    generator: Optional[torch.Generator] = None,
    *,
    cam_cfg: CameraParams = CameraParams(),
    params: RaymarchParams = RaymarchParams(),
    light_sample: Optional[torch.Tensor] = None,
    spp: int = 1,
    impl: str = "auto",
) -> GBuffer:
    """Fused raymarch + G-buffer pass of the whole frame: see
    :func:`render_gbuffer_window`."""
    return render_gbuffer_window(
        scene, camera, prev_camera, generator, 0, 0, cam_cfg.height,
        cam_cfg.width, cam_cfg=cam_cfg, params=params,
        light_sample=light_sample, spp=spp, impl=impl)


@spanned("rdt.render")
def render_gbuffer_window(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    generator: Optional[torch.Generator],
    row0: int,
    col0: int,
    th: int,
    tw: int,
    *,
    cam_cfg: CameraParams = CameraParams(),
    params: RaymarchParams = RaymarchParams(),
    light_sample: Optional[torch.Tensor] = None,
    spp: int = 1,
    impl: str = "auto",
) -> GBuffer:
    """Fused raymarch + G-buffer pass; ``spp`` light samples per pixel
    average into the noisy render plane (1 = the serving noise level; a
    large ``spp`` approximates the clean image).  The planes cover the
    ``th`` x ``tw`` window of the frame at pixel (``row0``, ``col0``) (a
    tile of the sharded pipeline; the JAX package's
    ``render_gbuffer_window``): its rays, and its motion against the
    frame's pixel coordinates.

    ``light_sample`` replaces the draws from ``generator`` (tests pass the
    reference's samples): (3, th, tw) at ``spp = 1``, (spp, 3, th, tw) at
    any ``spp``.  At ``spp = 1`` the shadow ray, shading and motion are one
    pass (K8).  At ``spp > 1`` each sample marches its shadow ray (K13) and
    its direct light is summed in PyTorch, sample by sample (stacking them
    would hold spp·3·H·W floats); the sum is divided once by ``spp``.

    ``impl="auto"`` runs K7/K8/K13 through their wrappers, which pick the
    CUDA kernel or the plain version by device; with
    ``params.coarse_seed`` the march starts at the window's cone seed,
    taken from the camera (K15, then the seeded K7).  ``impl="plain"``
    runs the plain versions on any device and ignores ``coarse_seed``, as
    the JAX package's ``impl="jnp"`` does.  The material lookup, hit mask
    and depth stay in PyTorch, so gradients reach the (M, 3) material
    tables.
    """
    # imported here: the wrappers' module imports this one
    from .raymarch_cuda import (march_gbuf_cuda, shadow_factor_cuda,
                                shadow_shade_cuda)

    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl: {impl!r}")
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    shade, shadow = ((shadow_shade_cuda, shadow_factor_cuda)
                     if impl == "auto" else (shadow_shade, shadow_factor))
    H, W = th, tw
    if light_sample is not None and light_sample.dim() == 3:
        light_sample = light_sample[None]
    if light_sample is not None and light_sample.shape != (spp, 3, H, W):
        raise ValueError(f"light_sample: shape {tuple(light_sample.shape)}, "
                         f"expected {(spp, 3, H, W)}")
    ro, rd, _basis = camera_rays_window(camera, cam_cfg, row0, col0, H, W)
    if impl == "auto":
        # with coarse_seed, the window's cone seed comes from the camera
        t, hit, mat, n = march_gbuf_cuda(scene, ro, rd, params,
                                         camera=camera, cam_cfg=cam_cfg,
                                         window=(row0, col0))
    else:
        t, hit, mat, n = march_gbuf(scene, ro, rd, params)
    p = ro + t[None] * rd
    albedo, emission = _material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.to(ro.dtype)[None]
    albedo = albedo * hit_f
    emission = emission * hit_f

    def sample(s):
        return (light_sample[s] if light_sample is not None
                else sample_light(scene, generator, (H, W)))

    light = light_constants(scene)
    prev = (prev_camera_constants(prev_camera, cam_cfg)
            if prev_camera is not None else None)
    if spp == 1:
        render, _vis, motion = shade(scene, p, n, sample(0), albedo,
                                     emission, hit, light, prev, params,
                                     (cam_cfg.width, cam_cfg.height),
                                     (row0, col0))
    else:
        irr = None
        for s in range(spp):
            lp = sample(s)
            e = direct_light(p, n, lp, shadow(scene, p, n, lp, params), light)
            irr = e if irr is None else irr + e
        render = albedo * (irr / spp / math.pi + _AMBIENT) + emission
        motion = reprojection_motion(p, hit, prev,
                                     (cam_cfg.width, cam_cfg.height),
                                     (row0, col0))
    if motion is None:
        motion = torch.zeros((2, H, W), dtype=ro.dtype, device=ro.device)
    depth = torch.where(hit, t, torch.zeros_like(t))
    return GBuffer(render=render, albedo=albedo, normal=n * hit_f,
                   depth=depth, motion=motion, denoised=None)


# ---------------------------------------------------------------------------
# scene builders (the reference's Cornell box and procedural stress scene)
# ---------------------------------------------------------------------------

def _scene_from_arrays(device, *, spheres, sphere_mat, boxes, box_mat,
                       planes, plane_mat, albedo, emission, radiance) -> Scene:
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return Scene(
        sphere_params=f(spheres), sphere_mat=i(sphere_mat),
        box_params=f(boxes), box_mat=i(box_mat),
        plane_params=f(planes), plane_mat=i(plane_mat),
        materials=Materials(albedo=f(albedo), emission=f(emission)),
        light_center=f([0.0, 0.98, 1.25]),
        light_u=f([0.25, 0.0, 0.0]),
        light_v=f([0.0, 0.0, 0.20]),
        light_radiance=f(radiance),
    )


def cornell_scene(
    *,
    device=None,
    left_color=(0.75, 0.08, 0.08),
    right_color=(0.08, 0.65, 0.08),
    white=(0.85, 0.85, 0.85),
    box_color=(0.35, 0.35, 0.35),
    light_radiance=(18.0, 18.0, 18.0),
) -> Scene:
    """Cornell box in [-1,1]^2 x [0,2]: 5 walls, tall box, short box, sphere,
    ceiling rect light (x right, y up, z into the box; camera at -z).
    ``device`` defaults to the CUDA card (see ``device.resolve_device``)."""
    albedo = np.asarray([white, left_color, right_color, box_color, white,
                         (0.0, 0.0, 0.0)], np.float32)
    emission = np.zeros_like(albedo)
    emission[5] = light_radiance
    return _scene_from_arrays(
        device,
        spheres=[[-0.45, -0.72, 0.80, 0.28]], sphere_mat=[4],
        boxes=[[-0.35, -0.40, 1.30, 0.30, 0.60, 0.30],   # tall box
               [0.40, -0.70, 0.90, 0.28, 0.30, 0.28],    # short box
               [0.0, 0.995, 1.25, 0.25, 0.012, 0.20]],   # light slab
        box_mat=[3, 3, 5],
        planes=[[0, 1, 0, 1.0], [0, -1, 0, 1.0], [0, 0, -1, 2.0],
                [1, 0, 0, 1.0], [-1, 0, 0, 1.0]],
        plane_mat=[0, 0, 0, 1, 2],
        albedo=albedo, emission=emission, radiance=light_radiance)


def random_scene(n_spheres: int = 24, n_boxes: int = 24,
                 n_materials: int = 16, seed: int = 0, *,
                 device=None) -> Scene:
    """Procedural stress scene: the Cornell shell plus ``n_spheres`` spheres
    and ``n_boxes`` boxes over ``n_materials`` random materials.  Draws the
    same numpy numbers in the same order as the reference, so one seed gives
    the same scene in both packages."""
    rng = np.random.default_rng(seed)
    albedo = rng.uniform(0.05, 0.9, (n_materials, 3)).astype(np.float32)
    emission = np.zeros((n_materials, 3), np.float32)
    emission[n_materials - 1] = (18.0, 18.0, 18.0)
    planes = np.asarray([[0, 1, 0, 1.0], [0, -1, 0, 1.0], [0, 0, -1, 2.0],
                         [1, 0, 0, 1.0], [-1, 0, 0, 1.0]], np.float32)
    plane_mat = rng.integers(0, n_materials - 1, 5).astype(np.int32)

    def body_positions(n):
        return rng.uniform((-0.85, -0.85, 0.25), (0.85, 0.85, 1.85),
                           (n, 3)).astype(np.float32)

    sph = np.concatenate([
        body_positions(n_spheres),
        rng.uniform(0.05, 0.22, (n_spheres, 1)).astype(np.float32)], axis=1)
    sphere_mat = rng.integers(0, n_materials - 1, n_spheres).astype(np.int32)
    box_half = rng.uniform(0.04, 0.2, (n_boxes, 3)).astype(np.float32)
    boxes = np.concatenate([body_positions(n_boxes), box_half], axis=1)
    boxes[-1] = (0.0, 0.995, 1.25, 0.25, 0.012, 0.20)   # ceiling light slab
    box_mat = rng.integers(0, n_materials - 1, n_boxes).astype(np.int32)
    box_mat[-1] = n_materials - 1
    return _scene_from_arrays(
        device, spheres=sph, sphere_mat=sphere_mat, boxes=boxes,
        box_mat=box_mat, planes=planes, plane_mat=plane_mat,
        albedo=albedo, emission=emission, radiance=(18.0, 18.0, 18.0))


def make_camera(position, look_at=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0), *,
                device=None) -> Camera:
    """A pinhole camera pose on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(position=f(position), look_at=f(look_at), up=f(up))


def cornell_camera(*, device=None) -> Camera:
    return make_camera([0.0, 0.0, -1.6], device=device)
