"""Worker processes for the port's sharded tests: gloo groups on the CPU.

The sharded test files (``tests/test_torch_halo.py``,
``tests/test_torch_sharded.py``, ``tests/test_torch_sharded_train.py``)
spawn one process a rank with :func:`run_group`, through the port's
``parallel.distributed.spawn_group``: each joins a gloo process group
through a file in the test's temporary directory, lays the ranks out with
``parallel.mesh.make_mesh`` and runs one of the workers below, which does
many checks in one group (a group costs seconds to start).  A worker
returns a dict of numpy arrays; :func:`run_group` hands the parent one
such dict a rank, and the parent holds them against the JAX package.
Nothing here imports jax: the spawned ranks import only torch and the
port.

Every group has a hard deadline: the rendezvous and every collective time
out after ``spawn_group``'s ``COLLECTIVE_TIMEOUT_S``, and the parent kills
the ranks that outlive ``join_timeout``, so a hung exchange fails its test
instead of eating the suite's time limit.
"""

from __future__ import annotations

import numpy as np
import torch

from raymarchdenoisercuda_torch.parallel.distributed import spawn_group


def _run_worker(mesh, device, worker, kwargs):
    return {k: np.asarray(v) for k, v in
            globals()[worker](mesh, **kwargs).items()}


def run_group(tmp_path, mesh_shape, worker, join_timeout=300, **kwargs):
    """Run ``worker(mesh, **kwargs)`` on a gloo group laid out as
    ``mesh_shape`` = (data, ny, nx); returns the ranks' result dicts, in
    rank order.  Raises with the ranks' tracebacks if one failed, and
    kills them if they outlive ``join_timeout`` seconds."""
    data, ny, nx = mesh_shape
    return spawn_group(data * ny * nx, "gloo", _run_worker,
                       dict(worker=worker, kwargs=kwargs), data=data,
                       join_timeout=join_timeout, workdir=str(tmp_path))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _n(t):
    """A numpy copy (a view would follow later in-place updates)."""
    return t.detach().numpy().copy()


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def halo_worker(mesh, x, halos, weights):
    """Each rank's padded tile of ``x`` for exchange_rows/cols/halo2d at
    each halo, and (rank 0) the global gradient of Σ weights·padded over
    all ranks, where ``weights[kind, h]`` is a global array of the padded
    tiles laid side by side (the JAX shard_map output layout)."""
    import torch.distributed as dist

    from raymarchdenoisercuda_torch.parallel.halo import (
        exchange_cols, exchange_halo2d, exchange_rows)
    from raymarchdenoisercuda_torch.parallel.mesh import (shard_plane,
                                                          unshard_plane)

    fns = dict(rows=exchange_rows, cols=exchange_cols, both=exchange_halo2d)
    _, iy, ix = mesh.coords
    out = {}
    for kind, fn in fns.items():
        for h in halos:
            xt = shard_plane(mesh, _t(x)).requires_grad_()
            padded = fn(xt, h, mesh)
            ph, pw = padded.shape[-2:]
            w = _t(weights[kind, h])[..., iy * ph:(iy + 1) * ph,
                                     ix * pw:(ix + 1) * pw]
            (padded * w).sum().backward()
            out[f"{kind}{h}"] = _n(padded)
            out[f"grad_{kind}{h}"] = _n(unshard_plane(mesh, xt.grad))
    dist.barrier()
    return out


def sweep_worker(mesh, cases):
    """Global outputs (color, variance, feedback) of svgf_spatial_sharded
    for each case ``name -> (planes, params, impl, bwd_impl)``."""
    from raymarchdenoisercuda_torch.parallel.sharded import (
        svgf_spatial_sharded)

    out = {}
    for name, (planes, params, impl, bwd) in cases.items():
        with torch.no_grad():
            c, v, fb = svgf_spatial_sharded(
                *(_t(p) for p in planes), mesh=mesh, params=params,
                return_feedback=True, impl=impl, bwd_impl=bwd)
        out[f"{name}_color"], out[f"{name}_variance"] = _n(c), _n(v)
        out[f"{name}_feedback"] = _n(fb)
    return out


def sweep_grad_worker(mesh, cases):
    """d/d(color, variance) of Σ color² + Σ variance of the sharded sweep
    (the loss on the global outputs), for each case ``name -> (planes,
    params, impl, bwd_impl)``."""
    from raymarchdenoisercuda_torch.parallel.sharded import (
        svgf_spatial_sharded)

    out = {}
    for name, (planes, params, impl, bwd) in cases.items():
        c, v, n, d = (_t(p) for p in planes)
        c.requires_grad_()
        v.requires_grad_()
        oc, ov = svgf_spatial_sharded(c, v, n, d, mesh=mesh, params=params,
                                      impl=impl, bwd_impl=bwd)
        ((oc ** 2).sum() + ov.sum()).backward()
        out[f"{name}_dcolor"], out[f"{name}_dvariance"] = (_n(c.grad),
                                                           _n(v.grad))
    return out


def _frame(mesh, f):
    """The tile's GBuffer of a global frame dict of numpy planes."""
    from raymarchdenoisercuda_torch.gbuffer import GBuffer
    from raymarchdenoisercuda_torch.parallel.mesh import shard_plane

    return GBuffer(**{k: shard_plane(mesh, _t(v)) for k, v in f.items()})


def temporal_worker(mesh, frames, params, impls):
    """Two temporal steps of ``frames`` (global plane dicts) on the tiles,
    History carry or canvas carry per impl; (integrated, variance) of each
    frame, gathered."""
    from raymarchdenoisercuda_torch.gbuffer import History
    from raymarchdenoisercuda_torch.parallel import sharded as S
    from raymarchdenoisercuda_torch.parallel.mesh import unshard_plane

    Hg, Wg = frames[0]["depth"].shape
    out = {}
    for impl in impls:
        g0 = _frame(mesh, frames[0])
        th, tw = g0.depth.shape
        canvas = impl in S.CANVAS_TEMPORALS
        hist = (S.init_history_canvas(mesh, Hg, Wg, params, device="cpu")
                if canvas
                else History.zeros(th, tw, device="cpu"))
        for k, f in enumerate(frames):
            g = _frame(mesh, f)
            with torch.no_grad():
                if impl == "fused_canvas":
                    integ, var, hist = S.temporal_accumulate_canvas_fused_local(
                        g, hist, Hg, Wg, mesh=mesh, params=params)
                elif impl == "ad_canvas":
                    integ, var, hist = S.temporal_accumulate_canvas_local(
                        g, hist, Hg, Wg, mesh=mesh, params=params)
                else:
                    integ, var, hist = S.temporal_accumulate_local(
                        g, hist, Hg, Wg, mesh=mesh, params=params, impl=impl)
            out[f"{impl}_integrated{k}"] = _n(unshard_plane(mesh, integ))
            out[f"{impl}_variance{k}"] = _n(unshard_plane(mesh, var))
        length = (S.history_from_canvas(hist, th, tw, params).length
                  if canvas else hist.length)
        out[f"{impl}_length"] = _n(unshard_plane(mesh, length.contiguous()))
    return out


def temporal_grad_worker(mesh, frames, params, cot, motion_grad=True):
    """Gradients of Σ cot·integrated of the second temporal step on the
    history canvas with respect to the first frame's render (through the
    carried canvas and its margin exchange) and, with ``motion_grad`` (K5c;
    else K6c), to the second frame's motion, gathered."""
    from raymarchdenoisercuda_torch.parallel import sharded as S
    from raymarchdenoisercuda_torch.parallel.mesh import (shard_plane,
                                                          unshard_plane)

    Hg, Wg = frames[0]["depth"].shape
    g1, g2 = _frame(mesh, frames[0]), _frame(mesh, frames[1])
    r1 = g1.render.clone().requires_grad_()
    m2 = g2.motion.clone().requires_grad_(motion_grad)
    canvas = S.init_history_canvas(mesh, Hg, Wg, params, device="cpu")
    _, _, canvas = S.temporal_accumulate_canvas_local(
        g1.replace(render=r1), canvas, Hg, Wg, mesh=mesh, params=params)
    integ, _, _ = S.temporal_accumulate_canvas_local(
        g2.replace(motion=m2), canvas, Hg, Wg, mesh=mesh, params=params,
        motion_grad=motion_grad)
    (integ * shard_plane(mesh, _t(cot))).sum().backward()
    out = dict(d_render=_n(unshard_plane(mesh, r1.grad)))
    if motion_grad:
        out["d_motion"] = _n(unshard_plane(mesh, m2.grad))
    return out


def _scene(scene_np):
    from raymarchdenoisercuda_torch import convert

    return convert.scene_from_numpy(scene_np, "cpu")


def pipeline_worker(mesh, scene_np, cams, lights, cam_cfg, rm_params,
                    svgf_params, impls):
    """The sharded pipeline over the frames (camera dicts, global light
    samples), per (impl, temporal_impl); the gathered denoised frames and
    G-buffer planes."""
    from raymarchdenoisercuda_torch.gbuffer import History
    from raymarchdenoisercuda_torch.ops.raymarch import make_camera
    from raymarchdenoisercuda_torch.parallel import sharded as S
    from raymarchdenoisercuda_torch.parallel.mesh import unshard_plane

    scene = _scene(scene_np)
    Hg, Wg = cam_cfg.height, cam_cfg.width
    _, ny, nx = mesh.shape
    out = {}
    for impl, temporal in impls:
        run = S.make_sharded_pipeline(
            mesh, Hg, Wg, cam_cfg=cam_cfg, rm_params=rm_params,
            svgf_params=svgf_params, impl=impl, temporal_impl=temporal)
        t = (S._default_temporal(impl, False) if temporal == "auto"
             else temporal)
        hist = (S.init_history_canvas(mesh, Hg, Wg, svgf_params,
                                      device="cpu")
                if t in S.CANVAS_TEMPORALS
                else History.zeros(Hg // ny, Wg // nx, device="cpu"))
        prev = None
        for k, (cam, lp) in enumerate(zip(cams, lights)):
            cam = make_camera(**cam, device="cpu")
            g, hist = run(scene, cam, prev, hist, light_sample=_t(lp))
            for name in ("denoised", "albedo", "depth"):
                out[f"{impl}_{temporal}_{name}{k}"] = _n(unshard_plane(
                    mesh, getattr(g, name).contiguous()))
            prev = cam
    return out


def train_worker(mesh, scene_np, cam, target, lights, cam_cfg, rm_params,
                 svgf_params, impl):
    """Sharded train steps, one a light sample: each step's loss, albedo
    gradient and albedo."""
    from raymarchdenoisercuda_torch.ops.raymarch import make_camera
    from raymarchdenoisercuda_torch.parallel import sharded as S

    scene = _scene(scene_np)
    Hg, Wg = target.shape[-2:]
    step = S.make_sharded_train_step(
        mesh, scene, make_camera(**cam, device="cpu"), _t(target),
        cam_cfg=cam_cfg, rm_params=rm_params, svgf_params=svgf_params,
        impl=impl)
    state = S.init_sharded_train_state(mesh, scene.materials.albedo, Hg, Wg,
                                       svgf_params, impl=impl)
    out = {}
    for k, lp in enumerate(lights):
        state, loss = step(state, light_sample=_t(lp))
        out[f"loss{k}"] = float(loss)
        out[f"grad{k}"] = _n(state.albedo.grad)
        out[f"albedo{k}"] = _n(state.albedo)
    return out


def multi_worker(mesh, jobs):
    """Several workers in one group (one start-up for many checks):
    ``jobs`` maps a name to (worker, kwargs); the results come back as
    ``"name/key"``."""
    out = {}
    for name, (worker, kwargs) in jobs.items():
        for k, v in globals()[worker](mesh, **kwargs).items():
            out[f"{name}/{k}"] = v
    return out


def scaling_worker(mesh, tile, iterations, steps):
    """``parallel.scaling.time_sharded_step`` on this group (the plain
    sweep on gloo CPU ranks), and this rank's forward output of the same
    sweep on its tile of the harness's inputs, for the layout check."""
    from raymarchdenoisercuda_torch.config import SVGFParams
    from raymarchdenoisercuda_torch.parallel import scaling
    from raymarchdenoisercuda_torch.parallel.sharded import (
        svgf_spatial_local)

    seconds = scaling.time_sharded_step(mesh, tile=tile,
                                        iterations=iterations, steps=steps,
                                        impl="plain", device="cpu")
    _, ny, nx = mesh.shape
    c, v, n, z = scaling._inputs(tile, tile, mesh.coords, "cpu")
    out, _ = svgf_spatial_local(c, v, n, z, tile * ny, tile * nx, mesh=mesh,
                                params=SVGFParams(iterations=iterations))
    return {"seconds": seconds, "coords": np.asarray(mesh.coords),
            "out": _n(out)}
