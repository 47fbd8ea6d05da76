"""K7/K8/K13/K15 wrappers: the primary march, the shadow/shading pass, the
shadow visibility alone and the cone pre-march seed through the CUDA
kernels of ``ops/cuda/raymarch.cu``.

Counterparts of ``_march_call(emit_normals=True)`` (unseeded and seeded),
``shadow_shade_pallas``, ``shadow_factor_pallas``, ``_cone_seed_coarse``
and ``_cone_seed_coarse_analytic`` in
``raymarchdenoisercuda_tpu/ops/pallas/raymarch_tpu.py``.  CUDA tensors run
the kernels; CPU tensors run the plain versions ``ops.raymarch.march_gbuf``,
``ops.raymarch.shadow_shade``, ``ops.raymarch.shadow_factor`` and
``ops.raymarch.cone_march``.

With ``RaymarchParams.coarse_seed``, :func:`march_gbuf_cuda` first takes
the coarse grid of cone stops (:func:`cone_seed_cuda`: from the camera
when it is given, as ``raymarch_pallas_gbuf`` does, else from the ray
planes) and then marches each pixel from its block's stop
(:func:`march_gbuf_seeded_cuda`).

K7 (seeded or not), K8, K13 and K15 are compiled for the primitive counts
of the scenes in :data:`SHADE_SCENES` (their SDF unrolled, the parameters
and material ids in the constant bank) and once for counts known only at
run time; :func:`scene_key` picks the instantiation.

:func:`shadow_shade_cuda` is a ``torch.autograd.Function``: its backward
recomputes the shading and motion epilogue in PyTorch with the visibility
held constant (``_shade_bwd`` in the JAX package) and returns gradients for
the hit point, normal, light sample, albedo, emission and light constants;
the previous camera's get none (the camera is never optimised).
:func:`shadow_factor_cuda` (K13) returns a visibility that is piecewise
constant and carries no gradient, as the JAX package's ``stop_gradient``
makes it.  :func:`march_gbuf_cuda` and :func:`march_gbuf_seeded_cuda` run
K7 (K7s) as the forward of ``ops.raymarch._March``: the hit distance and
the fused normal are differentiable in the scene's geometry and the rays,
by the implicit-function adjoint and the recomputed normal chain, in
PyTorch (``_gbuf_fused_bwd`` in the JAX package, which computes it in XLA,
not in a kernel).  The cone seed does not enter that adjoint.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from ..config import CameraParams, RaymarchParams
from .cuda import _build
from .raymarch import (Camera, Scene, cone_march, cone_rays,
                       cone_rays_analytic, march, march_gbuf,
                       seed_grid_shape, shade_epilogue, shadow_factor,
                       shadow_shade)


class _MarchParams(ctypes.Structure):
    """Mirror of ``struct MarchParams`` in ``ops/cuda/raymarch.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "n_sph", "n_box", "n_pl", "max_steps")] + [
        (n, ctypes.c_float) for n in
        ("max_dist", "hit_eps", "hit_eps4", "normal_eps", "relax_omega")]


class _ShadeParams(ctypes.Structure):
    """Mirror of ``struct ShadeParams`` in ``ops/cuda/raymarch.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("H", "W", "n_sph", "n_box", "n_pl", "shadow_steps",
                 "has_prev", "cam_w", "cam_h", "row0", "col0")] + [
        (n, ctypes.c_float) for n in ("hit_eps", "relax_omega")]


def flatten_scene(scene: Scene) -> torch.Tensor:
    """The scene's primitives as one flat float32 vector: spheres (Ns, 4) |
    boxes (Nb, 6) | planes (Np, 4) | sphere, box and plane material ids."""
    return torch.cat([
        scene.sphere_params.reshape(-1).float(),
        scene.box_params.reshape(-1).float(),
        scene.plane_params.reshape(-1).float(),
        scene.sphere_mat.float(), scene.box_mat.float(),
        scene.plane_mat.float()]).contiguous()


def _counts(scene: Scene):
    return (scene.sphere_params.shape[0], scene.box_params.shape[0],
            scene.plane_params.shape[0])


# the (spheres, boxes, planes) counts K7, K8, K13 and K15 are compiled for,
# in the order of rdt_march's, rdt_shadow_shade's, rdt_shadow's and
# rdt_cone_seed(_camera)'s scene keys 1, 2, ... (ops/cuda/raymarch.cu): the
# Cornell box of every main path and random_scene's default
SHADE_SCENES = ((1, 3, 5), (24, 24, 5))


def scene_key(scene: Scene) -> int:
    """K7's, K8's, K13's and K15's instantiation for ``scene``: the 1-based
    index of its counts in :data:`SHADE_SCENES`, or 0, the instantiation
    for any counts."""
    counts = _counts(scene)
    return (SHADE_SCENES.index(counts) + 1 if counts in SHADE_SCENES
            else 0)


def _march_params(H, W, scene, params):
    n_sph, n_box, n_pl = _counts(scene)
    return _MarchParams(H=H, W=W, n_sph=n_sph, n_box=n_box, n_pl=n_pl,
                        max_steps=params.max_steps, max_dist=params.max_dist,
                        hit_eps=params.hit_eps, hit_eps4=params.hit_eps * 4.0,
                        normal_eps=params.normal_eps,
                        relax_omega=params.relax_omega)


def _march_launch(scene, ro, rd, params, seed, key=None):
    """One launch of K7 (``seed`` None: from 0) in the instantiation
    ``key`` (default :func:`scene_key`; a compiled key given other counts
    raises); returns ``((t, hit, mat, n), key)``."""
    H, W = ro.shape[-2:]
    dev = ro.device
    f32 = torch.float32
    sc = flatten_scene(scene)
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (sc, "scene", sc.shape), (ro, "ro", (3, H, W)), (rd, "rd", (3, H, W)))]
    seed_ptr = (None if seed is None else _build.check_input(
        seed, "seed", seed_grid_shape(H, W), f32, dev))
    t = torch.empty((H, W), dtype=f32, device=dev)
    hit = torch.empty((H, W), dtype=torch.bool, device=dev)
    mat = torch.empty((H, W), dtype=torch.int32, device=dev)
    n = torch.empty((3, H, W), dtype=f32, device=dev)
    p = _march_params(H, W, scene, params)
    key = scene_key(scene) if key is None else key
    rc = _build.kernels().rdt_march(
        *ptrs[:3], seed_ptr, t.data_ptr(), hit.data_ptr(), mat.data_ptr(),
        n.data_ptr(), ctypes.addressof(p), key,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_march")
    return (t, hit, mat, n), key


def march_gbuf_cuda(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                    params: RaymarchParams, *, camera: Optional[Camera] = None,
                    cam_cfg: Optional[CameraParams] = None,
                    window: Tuple[int, int] = (0, 0)):
    """Primary march + G-buffer normals; returns ``(t, hit, mat, normal)``
    as ``march_gbuf`` does.  With ``params.coarse_seed`` the march is
    seeded: the cone stops come from ``camera`` (whose window at GLOBAL
    pixel ``window`` the rays ``ro``, ``rd`` must be; ``cam_cfg`` its
    configuration), or from the ray planes without a camera, and
    :func:`march_gbuf_seeded_cuda` marches.  Each unseeded launch adds one
    to ``march_gbuf_cuda.launches`` and to ``march_gbuf_cuda.by_key`` under
    its instantiation's :func:`scene_key`.  Differentiable in the scene's
    geometry and the rays (see the module docstring)."""
    if params.coarse_seed:
        H, W = ro.shape[-2:]
        if camera is not None:
            seed, _delta, _base = cone_seed_cuda(
                scene, params, camera=camera, cam_cfg=cam_cfg,
                window=window, shape=(H, W))
        else:
            seed, _delta, _base = cone_seed_cuda(scene, params, ro, rd)
        return march_gbuf_seeded_cuda(scene, ro, rd, seed, params)
    if not ro.is_cuda:
        return march_gbuf(scene, ro, rd, params)

    def launch():
        out, key = _march_launch(scene, ro.detach(), rd.detach(), params,
                                 None)
        march_gbuf_cuda.launches += 1
        march_gbuf_cuda.by_key[key] += 1
        return out

    return march(scene, ro, rd, params, launch, fused=True)


march_gbuf_cuda.launches = 0
march_gbuf_cuda.by_key = collections.Counter()


def march_gbuf_seeded_cuda(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                           seed: torch.Tensor, params: RaymarchParams):
    """The seeded K7: the march of ``march_gbuf`` with each pixel started
    at its block's stop in the (ceil(H/4), ceil(W/4)) grid ``seed``
    (``march_gbuf(seed=)`` on CPU tensors).  Each launch adds one to
    ``march_gbuf_seeded_cuda.launches`` and to its ``by_key``, as
    :func:`march_gbuf_cuda`'s.  Differentiable as :func:`march_gbuf_cuda`
    is, the seed held constant."""
    if not ro.is_cuda:
        return march_gbuf(scene, ro, rd, params, seed=seed.detach())

    def launch():
        out, key = _march_launch(scene, ro.detach(), rd.detach(), params,
                                 seed.detach())
        march_gbuf_seeded_cuda.launches += 1
        march_gbuf_seeded_cuda.by_key[key] += 1
        return out

    return march(scene, ro, rd, params, launch, fused=True)


march_gbuf_seeded_cuda.launches = 0
march_gbuf_seeded_cuda.by_key = collections.Counter()


def cone_seed_cuda(scene: Scene, params: RaymarchParams,
                   ro: Optional[torch.Tensor] = None,
                   rd: Optional[torch.Tensor] = None, *,
                   camera: Optional[Camera] = None,
                   cam_cfg: Optional[CameraParams] = None,
                   window: Tuple[int, int] = (0, 0),
                   shape: Optional[Tuple[int, int]] = None):
    """The coarse grid of cone stops, ``(t_c, delta, base)`` with t_c of
    shape (ceil(H/4), ceil(W/4)).  Two routes: from the ray planes ``ro``,
    ``rd`` (``_cone_seed_coarse``), or from ``camera`` for the ``shape`` =
    (th, tw) window at GLOBAL pixel ``window`` (``_cone_seed_coarse_
    analytic``).  On CUDA tensors K15 runs in the instantiation
    :func:`scene_key` picks: from the planes on the cones of PyTorch's
    ``cone_rays``; from the camera on cones it builds itself (two
    launches, no PyTorch glue; delta and base are the ones
    ``cone_rays_analytic`` gives, bit for bit).  CPU tensors take the glue
    and ``cone_march``.  delta and base stay 0-d tensors on the device.
    Each seed pass adds one to ``cone_seed_cuda.launches``, to its
    ``by_key`` under the instantiation and to its ``by_route`` under
    "camera" or "planes"."""
    if camera is not None:
        if camera.position.is_cuda:
            out = _cone_camera_launch(scene, camera, cam_cfg, window, shape,
                                      params)
            _count_cone(scene, "camera")
            return out
        ro_c, rd_c, delta, base = cone_rays_analytic(
            camera, cam_cfg, window[0], window[1], *shape)
    else:
        ro_c, rd_c, delta, base = cone_rays(ro, rd)
    t_c = cone_launch(scene, ro_c, rd_c, delta, base, params)
    if ro_c.is_cuda:
        _count_cone(scene, "planes")
    return t_c, delta, base


cone_seed_cuda.launches = 0
cone_seed_cuda.by_key = collections.Counter()
cone_seed_cuda.by_route = collections.Counter()


def _count_cone(scene, route):
    cone_seed_cuda.launches += 1
    cone_seed_cuda.by_key[scene_key(scene)] += 1
    cone_seed_cuda.by_route[route] += 1


class _ConeCamera(ctypes.Structure):
    """Mirror of ``struct ConeCamera`` in ``ops/cuda/raymarch.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("cam_h", "cam_w", "row0", "col0")] + [
        (n, ctypes.c_float) for n in ("half_fov", "aspect")]


def cone_launch(scene, ro_c, rd_c, delta, base, params, key=None):
    """One launch of K15 on cones from ray planes (``cone_march`` of CUDA
    tensors) in the instantiation ``key`` (default :func:`scene_key`; a
    compiled key given other counts raises); counted by its caller,
    :func:`cone_seed_cuda`.  CPU tensors run ``cone_march``."""
    if not ro_c.is_cuda:
        return cone_march(scene, ro_c, rd_c, delta, base, params)
    Hc, Wc = ro_c.shape[-2:]
    dev = ro_c.device
    f32 = torch.float32
    sc = flatten_scene(scene)
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (sc, "scene", sc.shape), (ro_c, "ro_c", (3, Hc, Wc)),
        (rd_c, "rd_c", (3, Hc, Wc)), (delta, "delta", ()),
        (base, "base", ()))]
    t_c = torch.empty((Hc, Wc), dtype=f32, device=dev)
    p = _march_params(Hc, Wc, scene, params)
    key = scene_key(scene) if key is None else key
    rc = _build.kernels().rdt_cone_seed(
        *ptrs, t_c.data_ptr(), ctypes.addressof(p), key,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_cone_seed")
    return t_c


def _cone_camera_launch(scene, camera, cam_cfg, window, shape, params):
    """K15 from the camera on the card: ``(t_c, delta, base)`` of the
    ``shape`` window at GLOBAL pixel ``window``, the cones built on the
    device (``rdt_cone_seed_camera``)."""
    dev = camera.position.device
    f32 = torch.float32
    Hc, Wc = seed_grid_shape(*shape)
    sc = flatten_scene(scene)
    # held until the launch: a copy made by contiguous() must outlive it
    vecs = [v.detach().contiguous() for v in (camera.position,
                                               camera.look_at, camera.up)]
    ptrs = [_build.check_input(t, n, s, f32, dev) for t, n, s in (
        (sc, "scene", sc.shape), (vecs[0], "position", (3,)),
        (vecs[1], "look_at", (3,)), (vecs[2], "up", (3,)))]
    # ctypes rounds each Python float to float32 once, as torch.full and
    # PyTorch's multiply by a Python scalar do in the glue
    cam = _ConeCamera(cam_h=cam_cfg.height, cam_w=cam_cfg.width,
                      row0=window[0], col0=window[1],
                      half_fov=cam_cfg.fov_y / 2.0,
                      aspect=cam_cfg.width / cam_cfg.height)
    # [max squared deviation, delta, base]
    scratch = torch.empty(3, dtype=f32, device=dev)
    t_c = torch.empty((Hc, Wc), dtype=f32, device=dev)
    p = _march_params(Hc, Wc, scene, params)
    rc = _build.kernels().rdt_cone_seed_camera(
        *ptrs, ctypes.addressof(cam), scratch.data_ptr(),
        t_c.data_ptr(), ctypes.addressof(p), scene_key(scene),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_cone_seed_camera")
    return t_c, scratch[1], scratch[2]


def _shade_launch(scene, p, n, light_p, albedo, emission, hit, light_consts,
                  prev_consts, params, cam_wh, window):
    """One launch of K8; returns ``(render, vis, motion)``."""
    H, W = p.shape[-2:]
    dev = p.device
    f32 = torch.float32
    sc = flatten_scene(scene).detach()
    planes = [(sc, "scene", sc.shape), (p, "p", (3, H, W)),
              (n, "n", (3, H, W)), (light_p, "light_p", (3, H, W)),
              (albedo, "albedo", (3, H, W)),
              (emission, "emission", (3, H, W))]
    ptrs = [_build.check_input(t, nm, s, f32, dev) for t, nm, s in planes]
    hit_ptr = _build.check_input(hit, "hit", (H, W), torch.bool, dev)
    light_ptr = _build.check_input(light_consts, "light_consts", (7,), f32,
                                   dev)
    has_prev = prev_consts is not None
    prev_ptr = (_build.check_input(prev_consts, "prev_consts", (14,), f32, dev)
                if has_prev else None)
    render = torch.empty((3, H, W), dtype=f32, device=dev)
    vis = torch.empty((H, W), dtype=f32, device=dev)
    motion = (torch.empty((2, H, W), dtype=f32, device=dev) if has_prev
              else None)
    n_sph, n_box, n_pl = _counts(scene)
    prm = _ShadeParams(H=H, W=W, n_sph=n_sph, n_box=n_box, n_pl=n_pl,
                       shadow_steps=params.shadow_steps,
                       has_prev=int(has_prev), cam_w=cam_wh[0],
                       cam_h=cam_wh[1], row0=window[0], col0=window[1],
                       hit_eps=params.hit_eps,
                       relax_omega=params.relax_omega)
    key = scene_key(scene)
    rc = _build.kernels().rdt_shadow_shade(
        *ptrs, hit_ptr, light_ptr, prev_ptr, render.data_ptr(),
        vis.data_ptr(), motion.data_ptr() if has_prev else None,
        ctypes.addressof(prm), key,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_shadow_shade")
    shadow_shade_cuda.launches += 1
    shadow_shade_cuda.by_key[key] += 1
    return render, vis, motion


class _ShadowShade(torch.autograd.Function):
    """K8 forward (or, on the CPU, the plain ``shadow_shade``), backward by
    recomputing :func:`shade_epilogue` at the forward's visibility."""

    @staticmethod
    def forward(ctx, scene, p, n, light_p, albedo, emission, hit,
                light_consts, prev_consts, params, cam_wh, window):
        args = (scene, p, n, light_p, albedo, emission, hit, light_consts,
                prev_consts, params, cam_wh, window)
        render, vis, motion = (_shade_launch(*args) if p.is_cuda
                               else shadow_shade(*args))
        ctx.save_for_backward(p, n, light_p, albedo, emission, hit, vis,
                              light_consts, prev_consts)
        ctx.cam_wh, ctx.window = cam_wh, window
        ctx.mark_non_differentiable(vis)
        if motion is None:
            return render, vis
        return render, vis, motion

    @staticmethod
    def backward(ctx, g_render, _g_vis, g_motion=None):
        p, n, light_p, albedo, emission, hit, vis, light_consts, prev = (
            ctx.saved_tensors)
        diff = (p, n, light_p, albedo, emission, light_consts)
        need = ctx.needs_input_grad[1:6] + (ctx.needs_input_grad[7],)
        if not any(need):
            return (None,) * 12
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(nd) for x, nd in
                      zip(diff, need)]
            render, motion = shade_epilogue(
                leaves[0], leaves[1], leaves[2], leaves[3], leaves[4], hit,
                vis, leaves[5], prev, ctx.cam_wh, ctx.window)
            outs, cots = [render], [g_render]
            if motion is not None and g_motion is not None:
                outs.append(motion)
                cots.append(g_motion)
            wanted = [x for x, nd in zip(leaves, need) if nd]
            grads = iter(torch.autograd.grad(outs, wanted, cots,
                                             allow_unused=True))
        d = [next(grads) if nd else None for nd in need]
        return (None, d[0], d[1], d[2], d[3], d[4], None, d[5], None, None,
                None, None)


def shadow_shade_cuda(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                      light_p: torch.Tensor, albedo: torch.Tensor,
                      emission: torch.Tensor, hit: torch.Tensor,
                      light_consts: torch.Tensor,
                      prev_consts: Optional[torch.Tensor],
                      params: RaymarchParams, cam_wh: Tuple[int, int],
                      window: Tuple[int, int] = (0, 0)):
    """Shadow ray + shading + motion; returns ``(render, vis, motion)`` as
    ``shadow_shade`` does, differentiable (see the module docstring);
    ``window`` as there.  Each launch adds one to
    ``shadow_shade_cuda.launches`` and to ``shadow_shade_cuda.by_key``
    under its instantiation's :func:`scene_key`."""
    out = _ShadowShade.apply(scene, p, n, light_p, albedo, emission, hit,
                             light_consts, prev_consts, params, cam_wh,
                             tuple(window))
    return out if prev_consts is not None else (out[0], out[1], None)


shadow_shade_cuda.launches = 0
shadow_shade_cuda.by_key = collections.Counter()


def shadow_factor_cuda(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                       light_p: torch.Tensor,
                       params: RaymarchParams) -> torch.Tensor:
    """(H, W) shadow-ray visibility (K13), as ``shadow_factor`` returns it;
    no gradient (the inputs are read detached).  Each launch adds one to
    ``shadow_factor_cuda.launches`` and to ``shadow_factor_cuda.by_key``
    under its instantiation's :func:`scene_key`."""
    if not p.is_cuda:
        return shadow_factor(scene, p, n, light_p, params)
    H, W = p.shape[-2:]
    dev = p.device
    f32 = torch.float32
    sc = flatten_scene(scene).detach()
    ptrs = [_build.check_input(t.detach(), nm, s, f32, dev) for t, nm, s in (
        (sc, "scene", sc.shape), (p, "p", (3, H, W)), (n, "n", (3, H, W)),
        (light_p, "light_p", (3, H, W)))]
    vis = torch.empty((H, W), dtype=f32, device=dev)
    n_sph, n_box, n_pl = _counts(scene)
    prm = _ShadeParams(H=H, W=W, n_sph=n_sph, n_box=n_box, n_pl=n_pl,
                       shadow_steps=params.shadow_steps, has_prev=0, cam_w=W,
                       cam_h=H, hit_eps=params.hit_eps,
                       relax_omega=params.relax_omega)
    key = scene_key(scene)
    rc = _build.kernels().rdt_shadow(
        *ptrs, vis.data_ptr(), ctypes.addressof(prm), key,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rdt_shadow")
    shadow_factor_cuda.launches += 1
    shadow_factor_cuda.by_key[key] += 1
    return vis


shadow_factor_cuda.launches = 0
shadow_factor_cuda.by_key = collections.Counter()
