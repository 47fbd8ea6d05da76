"""Plain PyTorch reference of the renderer: one light sample a pixel,
sphere-traced primary ray, central-difference normal, one shadow ray to a
point of the rectangular area light, direct light plus ambient, and the
motion of each hit point into the previous camera.

A frozen copy of the arithmetic of the port's plain renderer (the SDF
scene of spheres, boxes and planes; ``_raymarch_loop`` without relaxation;
the shadow march with its 0.01 minimum step).  It imports nothing of the
program, so a later change to the program cannot move it.  ``dtype`` runs
the same operations in another floating type (the lower-precision control).

A scene is a dict of tensors: ``spheres`` (Ns, 4), ``boxes`` (Nb, 6),
``planes`` (Np, 4), the material ids ``sphere_mat``, ``box_mat``,
``plane_mat`` (int64), ``albedo`` and ``emission`` (M, 3), and the light's
``light_center``, ``light_u``, ``light_v``, ``light_radiance`` (3,).  A
camera is a dict of ``position``, ``look_at``, ``up`` (3,).
"""

from __future__ import annotations

import math

import torch

AMBIENT = 0.08
SHADOW_MIN_STEP = 0.01
SHADOW_OFFSET = 0.02


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _normalize(v, eps=1e-8):
    return v / torch.clamp(_norm3(v), min=eps)


def _dot3(v, w):
    return v[0] * w[0] + v[1] * w[1] + v[2] * w[2]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def sdf(scene, p, want_mat=True):
    """Signed distance at points ``p`` (3, ...), and the material id of the
    nearest primitive (first on ties: spheres, boxes, planes)."""
    extra = (1,) * (p.dim() - 1)
    sp, bp, pp = scene["spheres"], scene["boxes"], scene["planes"]
    c = sp[:, :3].reshape(sp.shape[0], 3, *extra)
    d_sph = _norm3((p[None] - c).transpose(0, 1)) - sp[:, 3].reshape(
        -1, *extra)
    cb = bp[:, :3].reshape(bp.shape[0], 3, *extra)
    hb = bp[:, 3:].reshape(bp.shape[0], 3, *extra)
    q = (torch.abs(p[None] - cb) - hb).transpose(0, 1)
    zero = q.new_zeros(())
    d_box = _norm3(torch.maximum(q, zero)) + torch.minimum(
        torch.amax(q, 0), zero)
    shape = (-1,) + extra
    d_pl = (pp[:, 0].reshape(shape) * p[0][None]
            + pp[:, 1].reshape(shape) * p[1][None]
            + pp[:, 2].reshape(shape) * p[2][None]
            + pp[:, 3].reshape(shape))
    dists = torch.cat([d_sph, d_box, d_pl], 0)
    if not want_mat:
        return torch.amin(dists, 0)
    mats = torch.cat([scene["sphere_mat"], scene["box_mat"],
                      scene["plane_mat"]])
    d, idx = torch.min(dists, 0)
    return d, mats[idx]


def _normal(scene, p, rd, eps):
    """Unit central-difference normal at ``p``, flipped toward the viewer."""
    def d(axis, sign):
        off = torch.zeros(3, dtype=p.dtype, device=p.device)
        off[axis] = sign * eps
        return sdf(scene, p + off.reshape(3, *([1] * (p.dim() - 1))),
                   want_mat=False)

    n = _normalize(torch.stack([d(0, 1) - d(0, -1), d(1, 1) - d(1, -1),
                                d(2, 1) - d(2, -1)]))
    return torch.where(_dot3(n, rd)[None] > 0, -n, n)


def camera_basis(cam, width, height, fov_y):
    fwd = _normalize(cam["look_at"] - cam["position"])
    right = _normalize(_cross(cam["up"], fwd))
    up = _cross(fwd, right)
    half_h = torch.tan(torch.full((), fov_y / 2.0, dtype=fwd.dtype,
                                  device=fwd.device))
    half_w = half_h * (width / height)
    return fwd, right, up, half_w, half_h


def camera_rays(cam, width, height, fov_y, row0, rows):
    """Origins and unit directions (3, rows, W) of frame rows row0 .. +rows."""
    fwd, right, up, half_w, half_h = camera_basis(cam, width, height, fov_y)
    dev, dt = fwd.device, fwd.dtype
    ys = (0.5 - (row0 + torch.arange(rows, device=dev, dtype=dt) + 0.5)
          / height) * 2 * half_h
    xs = ((torch.arange(width, device=dev, dtype=dt) + 0.5) / width - 0.5
          ) * 2 * half_w
    dirs = (fwd[:, None, None] + up[:, None, None] * ys[None, :, None]
            + right[:, None, None] * xs[None, None, :])
    rd = _normalize(dirs)
    ro = cam["position"][:, None, None].expand_as(rd).contiguous()
    return ro, rd


def march(scene, ro, rd, rm):
    """Sphere-trace all rays in lock-step from 0; the loop ends once no ray
    moves (the result of running all ``max_steps``)."""
    if rm["relax_omega"] > 1.0:
        raise ValueError("the reference marches without over-relaxation")
    zero = torch.zeros(ro.shape[1:], dtype=ro.dtype, device=ro.device)
    t = zero
    for _ in range(rm["max_steps"]):
        d = sdf(scene, ro + t[None] * rd, want_mat=False)
        active = (d > rm["hit_eps"]) & (t < rm["max_dist"])
        if not bool(active.any()):
            break
        t = t + torch.where(active, d, zero)
    return t


def shadow_march(scene, origin, ld, dist_l, rm):
    """Visibility (0/1) of the light sample along the shadow ray."""
    zero = torch.zeros_like(dist_l)
    t = zero
    for _ in range(rm["shadow_steps"]):
        d = sdf(scene, origin + t[None] * ld, want_mat=False)
        active = (d > rm["hit_eps"]) & (t < dist_l - 0.02)
        if not bool(active.any()):
            break
        t = t + torch.where(active, torch.clamp(d, min=SHADOW_MIN_STEP),
                            zero)
    return (t >= dist_l - 0.03).to(dist_l.dtype)


def light_constants(scene):
    c = _cross(scene["light_u"], scene["light_v"])
    area = 4.0 * _norm3(c)
    return torch.cat([_normalize(c), scene["light_radiance"], area[None]])


def light_sample(scene, generator, height, width):
    """The light points (3, H, W) that one ``torch.rand((2, H, W))`` draw of
    ``generator`` gives: uniform on the light rectangle."""
    u = torch.rand((2, height, width), generator=generator,
                   dtype=torch.float32, device=generator.device) * 2.0 - 1.0
    u = u.to(scene["light_center"].dtype)
    return (scene["light_center"][:, None, None]
            + scene["light_u"][:, None, None] * u[0][None]
            + scene["light_v"][:, None, None] * u[1][None])


def motion_into(prev, p, hit, width, height, row0):
    """(2, rows, W) motion (dy, dx) in pixels of each hit point into the
    previous camera ``prev`` = (position, fwd, right, up, half_w, half_h);
    zero at misses."""
    ppos, pfwd, pright, pup, phw, phh = prev
    rel = p - ppos[:, None, None]
    z = _dot3(pfwd, rel)
    x = _dot3(pright, rel) / torch.clamp(z, min=1e-6)
    y = _dot3(pup, rel) / torch.clamp(z, min=1e-6)
    px = (x / phw * 0.5 + 0.5) * width - 0.5
    py = (0.5 - y / phh * 0.5) * height - 0.5
    iy = (row0 + torch.arange(p.shape[1], dtype=p.dtype,
                              device=p.device))[:, None]
    ix = torch.arange(p.shape[2], dtype=p.dtype, device=p.device)[None, :]
    return torch.stack([py - iy, px - ix]) * hit.to(p.dtype)[None]


def render_rows(scene, cam, prev_cam, lights, cfg, rm, row0, rows,
                albedo_table=None):
    """The G-buffer of frame rows row0 .. row0 + rows: a dict of ``render``,
    ``albedo``, ``normal`` (3, rows, W), ``depth`` (rows, W) and ``motion``
    (2, rows, W).  ``lights`` is the rows' light points;
    ``albedo_table`` (M, 3) replaces the scene's (a leaf of training)."""
    W, H, fov = cfg["width"], cfg["height"], cfg["fov_y"]
    ro, rd = camera_rays(cam, W, H, fov, row0, rows)
    with torch.no_grad():
        t = march(scene, ro, rd, rm)
        p = ro + t[None] * rd
        d_final, mat = sdf(scene, p)
        hit = (d_final <= rm["hit_eps"] * 4.0) & (t < rm["max_dist"])
        n = _normal(scene, p, rd, rm["normal_eps"])
        origin = p + SHADOW_OFFSET * n
        to_l = lights - origin
        dist_l = _norm3(to_l)
        ld = to_l / torch.clamp(dist_l, min=1e-8)[None]
        dist_l = torch.where(hit, dist_l, torch.zeros_like(dist_l))
        vis = shadow_march(scene, origin, ld, dist_l, rm)
        hit_f = hit.to(ro.dtype)[None]
        s = lights - p
        dist2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
        sd = s / torch.clamp(torch.sqrt(dist2), min=1e-8)[None]
        cos_s = torch.clamp(_dot3(n, sd), min=0.0)
        lc = light_constants(scene)
        ln, rad, area = lc[0:3], lc[3:6], lc[6]
        cos_l = torch.abs(ln[0] * sd[0] + ln[1] * sd[1] + ln[2] * sd[2])
        geom = cos_s * cos_l * area / torch.clamp(dist2, min=1e-4)
        irr = rad[:, None, None] * (vis * geom)[None]
        if prev_cam is None:
            motion = torch.zeros((2,) + t.shape, dtype=t.dtype,
                                 device=t.device)
        else:
            prev = (prev_cam["position"],) + camera_basis(prev_cam, W, H, fov)
            motion = motion_into(prev, p, hit, W, H, row0)
    idx = mat.reshape(-1)
    table = scene["albedo"] if albedo_table is None else albedo_table
    albedo = table.t()[:, idx].reshape((3,) + t.shape) * hit_f
    emission = scene["emission"].t()[:, idx].reshape((3,) + t.shape) * hit_f
    render = albedo * (irr / math.pi + AMBIENT) + emission
    depth = torch.where(hit, t, torch.zeros_like(t))
    return dict(render=render, albedo=albedo, normal=n * hit_f, depth=depth,
                motion=motion)


def render(scene, cam, prev_cam, generator, cfg, rm, *, block_rows=540,
           albedo_table=None):
    """The whole frame's G-buffer, marched in blocks of ``block_rows`` rows
    (each ray is independent, so the blocks give the frame's values); the
    light points are one draw of ``generator``, as the program draws them."""
    H, W = cfg["height"], cfg["width"]
    lights = light_sample(scene, generator, H, W)
    parts = [render_rows(scene, cam, prev_cam, lights[:, r:r + block_rows],
                         cfg, rm, r, min(block_rows, H - r), albedo_table)
             for r in range(0, H, block_rows)]
    return {k: torch.cat([p[k] for p in parts], -2) for k in parts[0]}
