"""The redesigned kernels of this tree against another tree's, on one GPU.

    python3 -m raymarchdenoisercuda_torch.utils.kernel_ab --parent DIR \\
        [--out build/kernel_ab.json] [--only REGEX] [--rounds N]
        [--device-time] [--by-kernel]

``DIR`` holds another checkout of the repository (an earlier commit,
unpacked with ``git archive``).  Its package is imported beside this one
under another name, each builds its kernels from its own sources into its
own ``build/``, and both run in this one process on the same inputs:
K1 (every radius 0-3, fast, exact and luminance-only weights, at every
level 0-4, with no store and with bf16 and float weight stores), K1b (with
and without float weights), K9, K14 (radius 0-5 and 8 at every level 0-4),
the bf16 forms (``precision="bf16"``, every radius 0-3 at every level 0-4,
on the frame and on a frame one row and three columns short): K1b-bf16
with a given σ-denominator (with and without float weights) and with σ
fused, written and not (a tree without the fused form runs
``sigma_denominator`` and then K1b-bf16, and gives that σ), K14-bf16 on
the σ and N its tree's forward gives, and the 5-level bf16 sweep at r1
and r2, inference and forward+backward,
the tile forms of K1/K1b/K14 on a quarter tile of a 3840x2160 frame at
levels 1 and 4 (K14 at radius 1-3, the others 1-2), K2/K2b (radius 0-5
and 8 at every level 0-4, bf16 and float weights, and the tile form at
radius 1 and 3, levels 1 and 4) and the
5-level inference sweep as ``chip_smoke.py`` phase 3 runs it, all at
1920x1080 on seeded planes; K7 on the rays of phase 3's camera and K8 on
the G-buffers, of the Cornell box, ``random_scene`` and a scene of other
primitive counts (their runtime-count instantiation): K7 with
``relax_omega`` 1.0 and 1.4, unseeded and seeded (both trees given the
seed grid of the other tree's K15), on a quarter window of the frame, and
seeded from the camera (each tree's K15, then its seeded march);
K8 with ``relax_omega`` 1.0 and 1.5, with and without the previous
camera, and on a window of the frame (the sharded path's launch); K13 on
K8's inputs of the three scenes with ``relax_omega`` 1.0 and 1.4; K3 on
``chip_smoke.py`` phase 3's kind of input (uniform random motion, short
histories) with motion scales 0, 3 and 14, the variance boost on and off,
the history clamp off, on a frame whose sides are no multiple of the
tile, on histories where a few pixels of each block are short and where
none is, and on a served frame's inputs (the ninth frame of phase 4's
orbit through this tree's pipeline); K16, the fused step's adjoint, on
K3's inputs of each kind (motion 14, 0 and 3, the boost off, the clamp
off, the moments' cotangent given, the odd frame, few and no short
pixels, the served frame) bit for bit against this tree's twin (an
earlier tree has no K16); K3u, K3's unbounded step (``max_motion=None``;
an earlier tree's route: KGp, KG and the plain epilogue), on random
motion to ±28 pixels, the served frame's with ``max_motion=None`` and at
twice its sides on ``serve_4k_unbounded``'s orbit, half a turn in (32
frames a turn); K3b on the quarter tiles of a
3840x2160 frame (phase 10(a)); K15 on each of the three scenes from
the camera (phase 3's, the frame's window at (0, 0) and a quarter window
of a 3840x2160 frame at (1080, 1920)), from phase 3's ray planes (outputs
t_c, delta and base) and the march launch alone on the camera's cones;
K12 at radius 0, 1, 2, 3, 4, 5, 8, 16 and 40 with
sigma_n 128 (repeated squaring) and 100 (powf), on a frame of sides
1079 x 1917 (no multiple of the tile) at radius 2 and 4, and at depth 2
through ``apply_filter(CROSS)``; K10 on ``chip_smoke.py`` phase 3's
colour planes at radius 0-6, 8, 12 and 16 with depth 1, at 4-6, 8, 12
and 16 with depth 2 (across the crossover of its 2-D body and its 1-D
passes, ``utils/tiling.py``'s ``BOX_PASS_RADIUS``: where this tree runs
the passes and the other the 2-D body, within rounding, and bit-equal to
this tree's twin in the cases ``K10 r<r> d<d> twin``), at r1 and r2 with
depth 3 and r2 with depth 5 (past the halo one launch stages), on the
frame one row and three columns short at r2 with depth 1 and 3, and at
depth 2 through ``apply_filter(AVERAGE)``; K11 at radius 0, 1, 2, 4 and
16 with sigma 0.5, 2 and 8 and at 5, 6, 8 and 12 with sigma r / 2, at
depth 1 and 2 (bit-equal on either route), on the short frame at r2 with
depth 1 and 2, and at depth 2 through ``apply_filter(GAUSSIAN)``; KG, the clamped
gather of unbounded
motion, on ``chip_smoke.py`` phase 3's input (uniform random motion to
±28 pixels), on motion 0, ±3 and ±80 pixels (taps clamped at the
border), on the served frame's input with ``max_motion=None`` and on a
frame one row and three columns short, each with a planar and a
channel-minor stack (a tree whose clamped gather takes planar stacks
only is given the planar one), and after the served step's stack (each
tree's: KGp, or the planar ``cat``); and KGb, its adjoint, on the same
inputs and layouts with both gradients, the history's only and the
motion's only: its motion gradient bit for bit, its history gradient (a
float64 sum in the atomics' order) to within rounding; K4, K5 and K6 (6
gradient planes) on uniform random motion to ±7 pixels (``chip_smoke.py``
phase 3's kind), its rounding, zero motion and the served frame's, and
K4c, K5c and K6c on the history canvases of the quarter tiles of a frame
of twice the sides (random and served motion, phase 10(a)'s cut): K4,
K4c and the motion gradients bit for bit, the history gradients to within
rounding (an earlier tree's K5/K6 add by atomics, in no fixed order).
The wide forms: K5/K6 past max_motion 59 (``K5w``/``K6w`` at 60, 96 and
128 on the random motion and on motion to ±(M + 1), at 1000 on the random
motion, and on a sink at 128 and 600; ``K5cw``/``K6cw`` on a quarter
tile's canvas at 60 and 96), this tree's scatter route at max_motion 6
against the other tree's K5/K6 (``K5s``/``K6s`` on random and served
motion), and K12 at radius 8, 40 (``K12``), 17 and 24 (``K12w``, and 17 on
the odd frame) are held to the other tree (a tree before 3dccd34 refuses
them); ``K10w`` and ``K11w`` (sigma r / 2), the 1-D passes, at radius 17,
24 and 90, at 17 with depth 2, on the odd frame at 17 and 90 and at 1200,
past the frame's height, bit-equal to the other tree, and at 17, 24 and
90 to this tree's twins (the cases ``... twin``): ``--only '^K[56]'``
and ``--only '^K1[012]'`` run them beside the others.
For each case it
prints whether every output is bit-equal to the other tree's
(``torch.equal``) and the largest difference, and times both trees in
turn, ``--rounds`` times each (default 2: this, other, this, other; with
more, the medians and spreads too), 20 launches a time, by CUDA events
around the launches or, with ``--device-time``, by the device time of
their kernels and memsets under the profiler (without the host's work,
which the events' wall holds for a short kernel); ``--rounds 0`` compares
the outputs only, and ``--by-kernel`` prints each tree's device time a
call by kernel (and memset or fill) under the profiler.
It prints ptxas's registers, stack and spills of the à-trous, march,
shading, shadow, temporal, cone, box, gaussian (and their 1-D passes),
cross-bilateral and clamped-gather kernels of each tree it builds (a
library built before is loaded as it is), and the card's name and power
limit.
It exits non-zero if an output held bit for bit differs, or if one held
within rounding differs by more than rtol 1e-5 (atol 1e-6 of its largest
magnitude).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda._build import parse_resources
from .tiling import BOX_PASS_RADIUS
from .seeded_inputs import (clamped_inputs, gather_inputs,
                            served_clamped_inputs, served_inputs,
                            sink_motion)
from .timing import (cuda_time_ms, device_ms, device_ms_by_kernel,
                     nvidia_smi_name_power)

PACKAGE = "raymarchdenoisercuda_torch"
REPEATS = 20
FRAME = (1080, 1920)                 # the main paths' frame (H, W)
# K4-K6's motions at FRAME, and K4c-K6c's on the quarter tiles of a frame
# of twice its sides (seeded_inputs.gather_inputs)
GATHER_KINDS = ("random", "integer", "zero", "served")
GATHER_KINDS_UHD = ("random", "served")
# K3's unbounded step at twice FRAME's sides: serve_4k_unbounded's orbit
# (benchmark/traffic/orbit_cornell_fast.json's period)
UHD_ORBIT_FRAMES = 32
# K14's and K2/K2b's radii: past 2 the staged forms at a compiled radius
# (3, and K14's 4) and at the runtime one, and the cache-read form where
# a level's staged tile is past the budget (utils/tiling.py)
ADJOINT_RADII = (0, 1, 2, 3, 4, 5, 8)
# K10's and K11's radii across the crossover of their 2-D bodies and 1-D
# passes (BOX_PASS_RADIUS, GAUSS_PASS_RADIUS), and past 16 a radius larger
# than the frame's height
ROUTE_RADII = (4, 5, 6, 8, 12, 16)
WIDE_PAST_FRAME = 1200


class Twin:
    """A case held against this tree's plain twin on the same inputs (a
    form the other tree refuses): ``launch(tree)`` gives the twin's
    zero-argument call; outputs within ``rtol`` and ``atol`` (absolute, or
    of the twin's largest magnitude with ``relative``)."""

    def __init__(self, launch, rtol=1e-5, atol=1e-6, relative=True):
        self.launch, self.rtol, self.atol = launch, rtol, atol
        self.relative = relative

    def close(self, a, b):
        return all(torch.allclose(x, y, rtol=self.rtol, atol=self.atol * (
            float(y.abs().max()) if self.relative else 1.0))
            for x, y in zip(a, b))


def load_tree(root: Path, alias: str):
    """The package of the checkout at ``root``, imported as ``alias``."""
    init = root / PACKAGE / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


class Tree:
    """The modules of one tree that the cases call."""

    def __init__(self, name: str):
        self.atrous_cuda = importlib.import_module(name + ".ops.atrous_cuda")
        self.atrous = importlib.import_module(name + ".ops.atrous")
        self.common = importlib.import_module(name + ".ops.common")
        self.build = importlib.import_module(name + ".ops.cuda._build")
        self.SVGFParams = importlib.import_module(name + ".config").SVGFParams
        self.raymarch_cuda = importlib.import_module(
            name + ".ops.raymarch_cuda")
        self.temporal_cuda = importlib.import_module(
            name + ".ops.temporal_cuda")
        self.temporal = importlib.import_module(name + ".ops.temporal")
        # whether its clamped gather takes a channel-minor stack
        self.channel_minor = hasattr(self.temporal,
                                     "history_stack_channel_minor")
        self.filters_cuda = importlib.import_module(name + ".ops.filters_cuda")
        self.filters = importlib.import_module(name + ".ops.filters")
        self.config = importlib.import_module(name + ".config")
        self.GBuffer = importlib.import_module(name + ".gbuffer").GBuffer


def planes(H, W, dev, seed):
    """Seeded colour, variance, normal and depth (``chip_smoke.py``'s
    ``random_planes``)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (t(rng.random((3, H, W))), t(0.02 * rng.random((H, W))), t(n),
            t(0.3 + 0.5 * rng.random((H, W))))


# K7's and K8's scenes: the two they are compiled for, and one of other
# counts
SCENES = (("cornell", {}), ("random", dict(seed=3)),
          ("odd", dict(n_spheres=7, n_boxes=4, seed=5)))


def _scene(raymarch, name, kw, dev):
    return (raymarch.cornell_scene(device=dev) if name == "cornell"
            else raymarch.random_scene(device=dev, **kw))


def march_inputs(dev, seed_tree):
    """``{scene name: (scene, ro, rd, seed grid)}``: K7's inputs at
    1920x1080, the rays of ``chip_smoke.py`` phase 3's camera and the
    coarse seed grid from that camera by ``seed_tree``'s K15 (the seed does
    not depend on ``relax_omega``)."""
    from ..config import CameraParams, RaymarchParams
    from ..io.generate import orbit_camera
    from ..ops import raymarch
    H, W = FRAME
    cfg = CameraParams(width=W, height=H)
    cam = orbit_camera(0.25, device=dev)
    ro, rd, _ = raymarch.camera_rays(cam, cfg)
    out = {}
    for name, kw in SCENES:
        scene = _scene(raymarch, name, kw, dev)
        seed = seed_tree.raymarch_cuda.cone_seed_cuda(
            scene, RaymarchParams(coarse_seed=True), camera=cam, cam_cfg=cfg,
            shape=(H, W))[0]
        out[name] = (scene, ro, rd, seed)
    return out


def shade_inputs(dev):
    """``{scene name: (scene, p, n, light sample, albedo, emission, hit,
    light constants, previous camera constants)}``: K8's inputs at
    1920x1080, from this tree's march of ``chip_smoke.py`` phase 3's
    camera."""
    from ..config import CameraParams, RaymarchParams
    from ..io.generate import orbit_camera
    from ..ops import raymarch
    H, W = FRAME
    cfg = CameraParams(width=W, height=H)
    out = {}
    for name, kw in SCENES:
        scene = _scene(raymarch, name, kw, dev)
        ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
        t, hit, mat, n = raymarch.march_gbuf(scene, ro, rd, RaymarchParams())
        alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                            scene.materials.emission)
        hit_f = hit.float()[None]
        lp = raymarch.sample_light(
            scene, torch.Generator(dev).manual_seed(0), (H, W))
        out[name] = (scene, ro + t[None] * rd, n, lp, alb * hit_f,
                     em * hit_f, hit, raymarch.light_constants(scene),
                     raymarch.prev_camera_constants(
                         orbit_camera(0.1875, device=dev), cfg))
    return out


def temporal_planes(H, W, dev, seed):
    """Seeded inputs of the temporal step (``chip_smoke.py``'s
    ``random_planes``): render, normal, depth, motion to ±7 pixels, and
    the history's colour, moments and lengths 0-5."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return dict(color=t(rng.random((3, H, W))), normal=t(n),
                depth=t(0.3 + 0.5 * rng.random((H, W))),
                motion=t((rng.random((2, H, W)) - 0.5) * 14.0),
                h_color=t(rng.random((3, H, W))),
                h_moments=t(rng.random((2, H, W))),
                h_length=t(np.floor(rng.random((H, W)) * 6)))


def temporal_inputs(dev):
    """K3's and K3b's inputs: :func:`temporal_planes` at ``FRAME`` and at
    twice its sides, and the served frame's; KG's and KGb's under
    ``"clamped"``: phase 3's (uniform random motion to ±28 pixels), motion
    0, ±3 and ±80 pixels, the served frame's (``max_motion=None``) and
    phase 3's on a frame one row and three columns short; K4-K6's under
    ``"gather"`` (random motion to ±7 pixels, integer, zero and the served
    frame's) and K4c-K6c's under ``"gather uhd"`` (random and served, at
    twice the sides); K3's unbounded step's under ``"unbounded"``: the
    served frame's with ``max_motion=None``, at ``FRAME`` and at twice its
    sides on the fast orbit (``UHD_ORBIT_FRAMES`` a turn)."""
    H, W = FRAME
    clamped = {f"motion {m:g}": clamped_inputs(H, W, dev, 2.0 * m)
               for m in (28, 0, 3, 80)}
    clamped["served"] = served_clamped_inputs(H, W, dev)
    clamped["odd frame"] = clamped_inputs(H - 1, W - 3, dev)
    return dict(frame=temporal_planes(H, W, dev, 21),
                uhd=temporal_planes(2 * H, 2 * W, dev, 22),
                served=served_inputs(H, W, dev), clamped=clamped,
                unbounded=dict(
                    served=served_inputs(H, W, dev, unbounded=True),
                    # the fast orbit of serve_4k_unbounded at twice the
                    # sides, half a turn in
                    **{"served uhd": served_inputs(
                        2 * H, 2 * W, dev, unbounded=True,
                        frame=UHD_ORBIT_FRAMES // 2,
                        orbit_frames=UHD_ORBIT_FRAMES)}),
                gather={k: gather_inputs(H, W, dev, k) for k in GATHER_KINDS},
                gather_uhd={k: gather_inputs(2 * H, 2 * W, dev, k)
                            for k in GATHER_KINDS_UHD})


def cases(P, U, cots, S, M, T):
    """``(name, fn, exact)``: ``fn(tree)`` is a zero-argument launch
    returning a tuple of tensors; ``exact``: the two trees' outputs must be
    bit-equal (else within rounding), or a tuple of that for each
    output."""
    for case in _cases(P, U, cots, S, M, T):
        yield case if len(case) == 3 else case + (True,)


def _step_outputs(out):
    integ, var, h = out
    return integ, var, h.moments, h.length


def _cases(P, U, cots, S, M, T):
    c, v, n, z = P

    def level(tree, r, level, wm, luma=None, store=None):
        p = tree.SVGFParams(radius=r, luma_only_from=luma)
        zgr = tree.common.finite_diff_gradients(z)
        kw = dict(level=level, params=p, weight_math=wm)
        if store is not None:
            kw.update(store=True, store_dtype=store)
        return lambda: tuple(tree.atrous_cuda.atrous_level_cuda(
            c, v, n, z, zgr, **kw))

    for r in (0, 1, 2, 3):
        for wm in ("fast", "exact"):
            for lvl in range(5):
                yield (f"K1 r{r} {wm} l{lvl}",
                       lambda t, r=r, wm=wm, lvl=lvl: level(t, r, lvl, wm))
    for r in (1, 2):
        for wm in ("fast", "exact"):
            for lvl in (0, 2, 4):
                yield (f"K1 r{r} {wm} luma-only l{lvl}",
                       lambda t, r=r, wm=wm, lvl=lvl: level(t, r, lvl, wm,
                                                            luma=0))
    for r in (0, 1, 2, 3):
        for wm in ("exact", "fast"):
            for dt, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for lvl in range(5):
                    yield (f"K1 store {dn} r{r} {wm} l{lvl}",
                           lambda t, r=r, wm=wm, dt=dt, lvl=lvl: level(
                               t, r, lvl, wm, store=dt))

    def k1b(tree, r, lvl, save):
        p = tree.SVGFParams(radius=r)
        zgr = tree.common.finite_diff_gradients(z)
        sd = tree.atrous.sigma_denominator(v, p)
        return lambda: tuple(tree.atrous_cuda.atrous_level_fwd_cuda(
            c, v, n, z, zgr, sd, level=lvl, params=p, save_weights=save))

    for r in (0, 1, 2, 3):
        for save in (False, True):
            for lvl in range(5):
                yield (f"K1b r{r}{' f32 weights' if save else ''} l{lvl}",
                       lambda t, r=r, lvl=lvl, save=save: k1b(t, r, lvl,
                                                             save))

    def k9(tree, r, lvl):
        p = tree.SVGFParams(radius=r)
        zgr = tree.common.finite_diff_gradients(z)
        sd = tree.atrous.sigma_denominator(v, p)
        oc, ov, norm = tree.atrous_cuda.atrous_level_fwd_cuda(
            c, v, n, z, zgr, sd, level=lvl, params=p)
        args = (c, v, n, z, zgr, sd, oc, ov, norm) + cots
        return lambda: tuple(tree.atrous_cuda.atrous_level_wgrad_bwd_cuda(
            *args, level=lvl, params=p))

    for r in (0, 1, 2, 3):
        for lvl in range(5):
            yield (f"K9 r{r} l{lvl}",
                   lambda t, r=r, lvl=lvl: k9(t, r, lvl))

    def tile(tree, kind, r, lvl):
        uc, uv, un, uz, ucots = U
        H, W = uz.shape
        th, tw = H // 2, W // 2
        p = tree.SVGFParams(radius=r)
        t_ = tree.common.Tile((0, tw), (H, W))
        h = r << lvl
        cc, vc, nc, dc = (tree.common.frame_canvas(x, t_, th, tw, h)
                          for x in (uc, uv, un, uz))
        zgr = tree.common.finite_diff_gradients(uz)[..., :th,
                                                    tw:].contiguous()
        kw = dict(level=lvl, params=p, tile=t_)
        fn = tree.atrous_cuda
        if kind == "K1b":
            sd = tree.atrous.sigma_denominator(uv, p)[:th, tw:].contiguous()
            return lambda: tuple(fn.atrous_level_fwd_cuda(
                cc, vc, nc, dc, zgr, sd, **kw))
        if kind == "K1 store":
            return lambda: tuple(fn.atrous_level_cuda(
                cc, vc, nc, dc, zgr, store=True, **kw))
        if kind == "K14":
            sd = tree.atrous.sigma_denominator(uv, p)[:th, tw:].contiguous()
            _, _, norm = fn.atrous_level_fwd_cuda(cc, vc, nc, dc, zgr, sd,
                                                  **kw)
            gc, gv = (x[..., :th, tw:].contiguous() for x in ucots)
            return lambda: tuple(fn.atrous_level_bwd_cuda(
                cc, nc, dc, zgr, sd, norm, gc, gv, out_halo=h, **kw))
        return lambda: tuple(fn.atrous_level_cuda(
            cc, vc, nc, dc, zgr, weight_math="fast", **kw))

    def k14(tree, r, lvl):
        p = tree.SVGFParams(radius=r)
        zgr = tree.common.finite_diff_gradients(z)
        sd = tree.atrous.sigma_denominator(v, p)
        _, _, norm = tree.atrous_cuda.atrous_level_fwd_cuda(
            c, v, n, z, zgr, sd, level=lvl, params=p)
        return lambda: tuple(tree.atrous_cuda.atrous_level_bwd_cuda(
            c, n, z, zgr, sd, norm, *cots, level=lvl, params=p))

    for r in ADJOINT_RADII:
        for lvl in range(5):
            yield (f"K14 r{r} l{lvl}",
                   lambda t, r=r, lvl=lvl: k14(t, r, lvl))

    # the bf16 forms on the frame and on one a row and three columns short
    # (an odd width: the last lane pair half outside): K1b-bf16 with σ
    # given (and float weights), with σ fused, written and not (a tree
    # without the fused form: sigma_denominator, then K1b-bf16, and that
    # σ), K14-bf16 on the σ and N its tree's forward gives, and the bf16
    # sweep, inference and fwd+bwd (outputs, colour and variance gradients)
    odd_planes = tuple(x[..., :-1, :-3].contiguous() for x in P)
    odd_cots = tuple(x[..., :-1, :-3].contiguous() for x in cots)

    def bf16_level(tree, r, lvl, odd):
        cc, vv, nn, zz = odd_planes if odd else P
        p = tree.SVGFParams(radius=r)
        zgr = tree.common.finite_diff_gradients(zz)
        return (cc, vv, nn, zz, zgr), dict(level=lvl, params=p,
                                           precision="bf16")

    def fused_sigma(tree):
        return hasattr(tree.atrous_cuda.atrous_level_fwd_cuda, "bf16_fused")

    def k1b_bf16(tree, r, lvl, save, odd):
        ins, kw = bf16_level(tree, r, lvl, odd)
        sd = tree.atrous.sigma_denominator(ins[1], kw["params"])
        return lambda: tuple(tree.atrous_cuda.atrous_level_fwd_cuda(
            *ins, sd, save_weights=save, **kw))

    def k1b_bf16_fused(tree, r, lvl, write, odd):
        ins, kw = bf16_level(tree, r, lvl, odd)
        fwd = tree.atrous_cuda.atrous_level_fwd_cuda
        if fused_sigma(tree):
            return lambda: tuple(fwd(*ins, None, return_sigma_denom=write,
                                     **kw))

        def glue():
            sd = tree.atrous.sigma_denominator(ins[1], kw["params"])
            return tuple(fwd(*ins, sd, **kw)) + ((sd,) if write else ())
        return glue

    def k14_bf16(tree, r, lvl, odd):
        ins, kw = bf16_level(tree, r, lvl, odd)
        fn = tree.atrous_cuda
        if fused_sigma(tree):
            _, _, norm, sd = fn.atrous_level_fwd_cuda(
                *ins, None, return_sigma_denom=True, **kw)
        else:
            sd = tree.atrous.sigma_denominator(ins[1], kw["params"])
            _, _, norm = fn.atrous_level_fwd_cuda(*ins, sd, **kw)
        cc, _, nn, zz, zgr = ins
        return lambda: tuple(fn.atrous_level_bwd_cuda(
            cc, nn, zz, zgr, sd, norm, *(odd_cots if odd else cots), **kw))

    def sweep_bf16(tree, r, grad, odd):
        planes = odd_planes if odd else P
        gc, gv = odd_cots if odd else cots
        p = tree.SVGFParams(radius=r, iterations=5)
        sweep = tree.atrous_cuda.svgf_spatial_ad_cuda

        def run():
            if not grad:
                return tuple(sweep(*planes, params=p, return_feedback=True,
                                   precision="bf16"))
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(k < 2)
                       for k, t in enumerate(planes)]
                oc, ov, fb = sweep(*ins, params=p, return_feedback=True,
                                   precision="bf16")
                loss = (oc * gc).sum() + (ov * gv).sum() + (fb * gc).sum()
                grads = torch.autograd.grad(loss, ins[:2])
            return (oc.detach(), ov.detach(), fb.detach()) + grads
        return run

    for odd in (False, True):
        frame = " odd frame" if odd else ""
        for r in (0, 1, 2, 3):
            for lvl in range(5):
                for save in (False, True):
                    yield (f"K1b-bf16 r{r}{' f32 weights' if save else ''}"
                           f"{frame} l{lvl}",
                           lambda t, r=r, lvl=lvl, save=save, odd=odd:
                           k1b_bf16(t, r, lvl, save, odd))
                for write in (False, True):
                    yield (f"K1b-bf16 fused σ{' written' if write else ''} "
                           f"r{r}{frame} l{lvl}",
                           lambda t, r=r, lvl=lvl, write=write, odd=odd:
                           k1b_bf16_fused(t, r, lvl, write, odd))
                yield (f"K14-bf16 r{r}{frame} l{lvl}",
                       lambda t, r=r, lvl=lvl, odd=odd: k14_bf16(t, r, lvl,
                                                                 odd))
        for r in (1, 2):
            for grad in (False, True):
                yield (f"sweep bf16 r{r} {'fwd+bwd' if grad else 'inference'}"
                       f"{frame}",
                       lambda t, r=r, grad=grad, odd=odd: sweep_bf16(
                           t, r, grad, odd))

    for kind in ("K1 fast", "K1 store", "K1b", "K14"):
        for r in (1, 2, 3) if kind == "K14" else (1, 2):
            for lvl in (1, 4):
                yield (f"tile {kind} r{r} l{lvl}",
                       lambda t, kind=kind, r=r, lvl=lvl: tile(t, kind, r,
                                                                 lvl))

    def k2(tree, r, lvl, dt, halo=False):
        # seeded weights (no border mask: the kernel drops an out-of-frame
        # centre by its coordinate), N and cotangents; a tile launch (a
        # quarter of the larger frame's cotangents) also writes its output
        # region's margins
        H, W = z.shape
        g = torch.Generator(z.device).manual_seed(100 * r + lvl)
        w = torch.rand(((2 * r + 1) ** 2, H, W), generator=g,
                       device=z.device).to(dt)
        norm = 0.2 + 2.0 * torch.rand((H, W), generator=g, device=z.device)
        gc, gv = (x[..., :H, :W].contiguous()
                  for x in (U[4] if halo else cots))
        return lambda: tuple(tree.atrous_cuda.atrous_level_bwd_stored_cuda(
            w, norm, gc, gv, level=lvl, radius=r,
            out_halo=r << lvl if halo else 0))

    for r in ADJOINT_RADII:
        for dt, kn in ((torch.bfloat16, "K2"), (torch.float32, "K2b")):
            for lvl in range(5):
                yield (f"{kn} r{r} l{lvl}",
                       lambda t, r=r, dt=dt, lvl=lvl: k2(t, r, lvl, dt))
    for dt, kn in ((torch.bfloat16, "K2"), (torch.float32, "K2b")):
        for r in (1, 3):
            for lvl in (1, 4):
                yield (f"tile {kn} r{r} l{lvl}",
                       lambda t, dt=dt, r=r, lvl=lvl: k2(t, r, lvl, dt,
                                                         halo=True))

    def k7(tree, name, omega, seeded, window, camera=False):
        rc = tree.raymarch_cuda
        rm = rc.RaymarchParams(relax_omega=omega)
        scene, ro, rd, seed = M[name]
        if camera:
            # the seeded path of render_gbuffer: K15 from the camera, then
            # the seeded march (phase 3's camera)
            from ..io.generate import orbit_camera
            H, W = FRAME
            cam = orbit_camera(0.25, device=ro.device)
            cfg = tree.config.CameraParams(width=W, height=H)
            rm = rc.RaymarchParams(coarse_seed=True)
            return lambda: tuple(rc.march_gbuf_cuda(scene, ro, rd, rm,
                                                    camera=cam, cam_cfg=cfg))
        if window:
            # the frame's lower right quarter
            H, W = FRAME
            ro, rd = (x[:, H // 2:, W // 2:].contiguous() for x in (ro, rd))
        if seeded:
            return lambda: tuple(rc.march_gbuf_seeded_cuda(scene, ro, rd,
                                                           seed, rm))
        return lambda: tuple(rc.march_gbuf_cuda(scene, ro, rd, rm))

    for name, _ in SCENES:
        for omega in (1.0, 1.4):
            for seeded in (False, True):
                yield (f"K7 {name} omega {omega}"
                       f"{' seeded' if seeded else ''}",
                       lambda t, name=name, omega=omega, seeded=seeded: k7(
                           t, name, omega, seeded, False))
        yield (f"K7 {name} window",
               lambda t, name=name: k7(t, name, 1.0, False, True))
        yield (f"K7 {name} seeded from the camera",
               lambda t, name=name: k7(t, name, 1.0, True, False, True))

    def k8(tree, name, omega, prev, window):
        rm = tree.raymarch_cuda.RaymarchParams(relax_omega=omega)
        scene, *planes, light, prev_c = S[name]
        H, W = FRAME
        # the window: the frame's lower right quarter
        origin = (H // 2, W // 2) if window else (0, 0)
        planes = [x[..., origin[0]:, origin[1]:].contiguous()
                  for x in planes]
        return lambda: tuple(x for x in tree.raymarch_cuda.shadow_shade_cuda(
            scene, *planes, light, prev_c if prev else None, rm, (W, H),
            origin) if x is not None)

    for name, _ in SCENES:
        for omega in (1.0, 1.5):
            for prev in (True, False):
                yield (f"K8 {name} omega {omega}"
                       f"{'' if prev else ' no prev'}",
                       lambda t, name=name, omega=omega, prev=prev: k8(
                           t, name, omega, prev, False))
        yield (f"K8 {name} window",
               lambda t, name=name: k8(t, name, 1.0, True, True))

    def k13(tree, name, omega):
        rm = tree.raymarch_cuda.RaymarchParams(relax_omega=omega)
        scene, p, nrm, lp = S[name][:4]
        return lambda: (tree.raymarch_cuda.shadow_factor_cuda(
            scene, p, nrm, lp, rm),)

    for name, _ in SCENES:
        for omega in (1.0, 1.4):
            yield (f"K13 {name} omega {omega}",
                   lambda t, name=name, omega=omega: k13(t, name, omega))

    def k3_inputs(tree, kind, scale=14.0, boost=4, clamp=True):
        # phase 3's kind of input with the motion scaled (0: every pixel
        # reprojects onto itself); "few": long valid histories (zero
        # motion, the current depth and normal) except one pixel in 256,
        # "none": no pixel short; "odd": a frame of sides 1079 x 1917;
        # "served": the served frame's inputs
        from ..gbuffer import GBuffer, History
        p = tree.SVGFParams(variance_boost_frames=boost, history_clamp=clamp)
        if kind == "served":
            g, h = T["served"]
            return g, h, p
        F = T["frame"]
        motion = F["motion"] * (scale / 14.0)
        length = F["h_length"]
        if kind in ("few", "none"):
            motion = torch.zeros_like(motion)
            length = torch.full_like(length, 10.0)
            if kind == "few":
                length[3::16, 17::16] = 0.0
        planes = dict(F, motion=motion, h_length=length)
        if kind == "odd":
            planes = {k: x[..., :1079, :1917].contiguous()
                      for k, x in planes.items()}
        g = GBuffer(render=planes["color"], albedo=planes["color"],
                    normal=planes["normal"], depth=planes["depth"],
                    motion=planes["motion"])
        h = History(color=planes["h_color"], moments=planes["h_moments"],
                    length=planes["h_length"], prev_depth=planes["depth"],
                    prev_normal=planes["normal"])
        return g, h, p

    def k3(tree, kind, scale=14.0, boost=4, clamp=True):
        g, h, p = k3_inputs(tree, kind, scale, boost, clamp)
        return lambda: _step_outputs(
            tree.temporal_cuda.temporal_accumulate_cuda(g, h, params=p))

    for scale in (0.0, 3.0, 14.0):
        for boost in (4, 0):
            yield (f"K3 motion {scale:g} boost {boost}",
                   lambda t, scale=scale, boost=boost: k3(
                       t, "random", scale, boost))
    yield "K3 motion 14 no clamp", lambda t: k3(t, "random", clamp=False)
    for kind in ("odd", "few", "none", "served"):
        yield f"K3 {kind}", lambda t, kind=kind: k3(t, kind)

    def k3u(tree, kind):
        # the unbounded step (max_motion=None): this tree's K3 body with
        # the clamped gather against the other tree's route (an earlier
        # tree: KGp, KG and the plain epilogue)
        if kind == "motion 28":
            g, h, p = k3_inputs(tree, "random", scale=56.0)
        else:
            g, h = T["unbounded"][kind]
            p = tree.SVGFParams()
        p = dataclasses.replace(p, max_motion=None)
        return lambda: _step_outputs(
            tree.temporal_cuda.temporal_accumulate_cuda(g, h, params=p))

    for kind in ("motion 28", "served", "served uhd"):
        yield f"K3u {kind}", lambda t, kind=kind: k3u(t, kind)

    def k16(tree, kind, scale=14.0, boost=4, clamp=True, moments=False,
            twin=False):
        # K16, the fused step's adjoint, on K3's input of the same kind
        # (its outputs from this tree's K3) for the cotangents of
        # integrated and variance (and of the new moments); ``twin``: its
        # plain twin on the same inputs
        g, h, p = k3_inputs(tree, kind, scale, boost, clamp)
        _, _, nh = tree.temporal_cuda.temporal_accumulate_cuda(g, h,
                                                               params=p)
        H, W = g.depth.shape
        gi, gv = (x[..., :H, :W].contiguous() for x in cots)
        gm = (torch.stack([gv, -gv]) if moments else None)
        fn = (tree.temporal.temporal_step_bwd_ref if twin else
              lambda *a: tree.temporal_cuda.temporal_bwd_cuda(
                  *a[:-1], params=a[-1]))
        return lambda: (fn(g, h, nh.moments, nh.length, gi, gv, gm, p),)

    # held bit for bit to this tree's twin (an earlier tree has no K16)
    for name, kw in (("motion 14 boost 4", {}),
                     ("motion 0 boost 4", dict(scale=0.0)),
                     ("motion 3 boost 0", dict(scale=3.0, boost=0)),
                     ("motion 14 no clamp", dict(clamp=False)),
                     ("motion 14 moments", dict(moments=True)),
                     ("odd", dict(kind="odd")), ("few", dict(kind="few")),
                     ("none", dict(kind="none")),
                     ("served", dict(kind="served"))):
        kw = dict(dict(kind="random"), **kw)
        yield (f"K16 {name}", lambda t, kw=kw: k16(t, **kw),
               Twin(lambda t, kw=kw: k16(t, twin=True, **kw), rtol=0.0,
                    atol=0.0))

    def k3b(tree, k):
        # the history canvas (margin max_motion + 1) and the render canvas
        # (margin 3) of quarter tile k of the larger frame
        from ..gbuffer import GBuffer
        Q = T["uhd"]
        H2, W2 = Q["depth"].shape
        th, tw = H2 // 2, W2 // 2
        p = tree.SVGFParams()
        tile = tree.common.Tile(((k // 2) * th, (k % 2) * tw), (H2, W2))
        stack = torch.cat([Q["h_color"], Q["h_moments"], Q["h_length"][None],
                           Q["depth"][None], Q["normal"]])
        canvas = tree.common.frame_canvas(stack, tile, th, tw,
                                          p.max_motion + 1)
        gy, gx = tile.origin

        def crop(x):
            return x[..., gy:gy + th, gx:gx + tw].contiguous()

        g = GBuffer(render=tree.common.frame_canvas(Q["color"], tile, th, tw,
                                                    3),
                    albedo=None, normal=crop(Q["normal"]),
                    depth=crop(Q["depth"]), motion=crop(Q["motion"]))
        return lambda: _step_outputs(
            tree.temporal_cuda.temporal_accumulate_canvas_cuda(
                g, canvas, params=p, tile=tile))

    for k in range(4):
        yield f"K3b quarter tile {k}", lambda t, k=k: k3b(t, k)

    def clamped(tree, kind, layout, grads=None):
        # KG (grads None) or KGb with (history_grad, motion_grad) on the
        # stack in ``layout``; a tree that takes planar stacks only gets
        # the planar one
        stack, motion, g = T["clamped"][kind]
        if layout == "channel-minor" and tree.channel_minor:
            stack = stack.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        tc = tree.temporal_cuda
        if grads is None:
            return lambda: (tc.clamped_gather_cuda(stack, motion),)
        hg, mg = grads
        return lambda: tuple(x for x in tc.clamped_gather_bwd_cuda(
            stack, motion, g, history_grad=hg, motion_grad=mg)
            if x is not None)

    for kind in T["clamped"]:
        for layout in ("planar", "channel-minor"):
            yield (f"KG {kind} {layout}",
                   lambda t, kind=kind, layout=layout: clamped(t, kind,
                                                               layout))

    def served_step(tree):
        # the served frame's history stacked as the tree's unbounded step
        # stacks it on the card (KGp; a tree without it: the planar
        # ``cat``), then KG: the step's whole cost of the gather
        stack, motion, _ = T["clamped"]["served"]
        hist = tree.temporal.history_from_stack(stack)
        build = getattr(tree.temporal_cuda,
                        "history_stack_channel_minor_cuda",
                        tree.temporal.history_stack)
        gather = tree.temporal_cuda.clamped_gather_cuda
        return lambda: (gather(build(hist), motion),)

    yield "KG served with the step's stack", served_step
    # KGb: d_motion bit-equal, d_stack (a float64 sum in the atomics'
    # order) within rounding
    for kind in T["clamped"]:
        for layout in ("planar", "channel-minor"):
            for grads, label in (((True, True), ""),
                                 ((True, False), " history only"),
                                 ((False, True), " motion only")):
                yield (f"KGb {kind} {layout}{label}",
                       lambda t, kind=kind, layout=layout, grads=grads:
                       clamped(t, kind, layout, grads),
                       tuple(ex for ex, keep in zip((False, True), grads)
                             if keep))

    def gather(tree, kind, k, quarter=None):
        # K4 (k = 4), K5 (5) or K6 (6), 6 gradient planes; with
        # ``quarter``, K4c/K5c/K6c on the history canvas (margin
        # max_motion + 1) of that quarter tile of the frame of twice the
        # sides, as chip_smoke.py phase 10(a) cuts it
        M = tree.SVGFParams().max_motion
        tc = tree.temporal_cuda
        if quarter is None:
            stack, motion, g = T["gather"][kind]
            if k == 4:
                return lambda: (tc.gather_cuda(stack, motion, M),)
            if k == 5:
                return lambda: tuple(tc.gather_bwd_cuda(
                    stack, motion, g, M, grad_planes=6))
            return lambda: tuple(tc.gather_bwd_hist_cuda(
                motion, g, M, grad_planes=6))
        stack, motion, g = T["gather_uhd"][kind]
        H2, W2 = motion.shape[-2:]
        th, tw = H2 // 2, W2 // 2
        tile = tree.common.Tile(((quarter // 2) * th, (quarter % 2) * tw),
                                (H2, W2))
        canvas = tree.common.frame_canvas(stack, tile, th, tw, M + 1)
        gy, gx = tile.origin
        m_t, g_t = (x[..., gy:gy + th, gx:gx + tw].contiguous()
                    for x in (motion, g))
        if k == 4:
            return lambda: (tc.gather_canvas_cuda(canvas, m_t, M,
                                                  tile=tile),)
        if k == 5:
            return lambda: tuple(tc.gather_canvas_bwd_cuda(
                canvas, m_t, g_t, M, tile=tile, grad_planes=6))
        return lambda: tuple(tc.gather_canvas_bwd_hist_cuda(
            m_t, g_t, M, tile=tile, canvas_shape=canvas.shape,
            grad_planes=6))

    # K4/K4c and the motion gradient bit-equal; the history gradient within
    # rounding (the parent's adjoint adds by atomics, in no fixed order)
    for k in (4, 5, 6):
        exact = True if k == 4 else (False, True)
        for kind in GATHER_KINDS:
            yield (f"K{k} {kind}",
                   lambda t, kind=kind, k=k: gather(t, kind, k), exact)
        for kind in GATHER_KINDS_UHD:
            for q in range(4):
                yield (f"K{k}c {kind} quarter tile {q}",
                       lambda t, kind=kind, k=k, q=q: gather(t, kind, k, q),
                       exact)

    def wide_gather(tree, k, Mw, kind, canvas=False):
        # K5/K6 (k = 5, 6) at a max_motion past the staged region, on
        # phase 3's random motion (±7 px), on motion to ±(Mw + 1) ("wide")
        # or with the sink (every source of the (2 Mw + 1)^2 window around
        # the middle anchored there); with ``canvas``, K5c/K6c on the lower
        # right quarter tile's canvas
        tc = tree.temporal_cuda
        stack, motion, g = T["gather"]["random"]
        if kind == "wide":
            motion = motion * ((Mw + 1.0) / 7.0)
        elif kind == "sink":
            motion = sink_motion(motion, Mw)
        if not canvas:
            if k == 5:
                return lambda: tuple(tc.gather_bwd_cuda(
                    stack, motion, g, Mw, grad_planes=6))
            return lambda: tuple(tc.gather_bwd_hist_cuda(
                motion, g, Mw, grad_planes=6))
        H, W = motion.shape[-2:]
        th, tw = H // 2, W // 2
        tile = tree.common.Tile((H - th, W - tw), (H, W))
        cv = tree.common.frame_canvas(stack, tile, th, tw, Mw + 1)
        m_t, g_t = (x[..., H - th:, W - tw:].contiguous() for x in (motion,
                                                                   g))
        if k == 5:
            return lambda: tuple(tc.gather_canvas_bwd_cuda(
                cv, m_t, g_t, Mw, tile=tile, grad_planes=6))
        return lambda: tuple(tc.gather_canvas_bwd_hist_cuda(
            m_t, g_t, Mw, tile=tile, canvas_shape=cv.shape, grad_planes=6))

    # past max_motion 59, held to the other tree (an earlier tree than
    # 3dccd34 refuses them): K5/K6 at M60, M96 and M128 on the random and the
    # wide motion, at M1000 on the random motion, the sink at M128 and M600
    # (1.3 M sources on one anchor, sorted in five bitmap passes), and
    # K5c/K6c on motion to ±(M + 1)
    for k in (5, 6):
        for Mw, kind in ((60, "random"), (60, "wide"), (96, "random"),
                         (96, "wide"), (128, "random"), (128, "wide"),
                         (128, "sink"), (600, "sink"), (1000, "random")):
            yield (f"K{k}w M{Mw} {kind}",
                   lambda t, k=k, Mw=Mw, kind=kind: wide_gather(
                       t, k, Mw, kind))
        for Mw in (60, 96):
            yield (f"K{k}cw M{Mw} wide quarter tile 3",
                   lambda t, k=k, Mw=Mw: wide_gather(t, k, Mw, "wide",
                                                     True))

    def scatter_at(tree, k, kind):
        # this tree's scatter route at phase 3's max_motion, where its
        # wrappers take the staged gather (the other tree's K5/K6: the same
        # floats)
        tc = tree.temporal_cuda
        Mb = tree.SVGFParams().max_motion
        stack, motion, g = T["gather"][kind]
        if not g.is_cuda or "scatter" not in inspect.signature(
                tc._gather_bwd).parameters:
            if k == 5:
                return lambda: tuple(tc.gather_bwd_cuda(stack, motion, g, Mb,
                                                        grad_planes=6))
            return lambda: tuple(tc.gather_bwd_hist_cuda(motion, g, Mb,
                                                         grad_planes=6))
        return lambda: tuple(tc._gather_bwd(
            stack if k == 5 else None, motion, g, Mb, k == 5, 6,
            scatter=True))

    # the history gradient within rounding of a tree whose K5/K6 add by
    # atomics, as K5/K6's cases
    for k in (5, 6):
        for kind in ("random", "served"):
            yield (f"K{k}s M6 {kind}",
                   lambda t, k=k, kind=kind: scatter_at(t, k, kind),
                   (False, True))

    def k15(tree, name, route):
        # phase 3's camera and rays; "quarter": the window at (H, W) of a
        # frame of twice the sides
        from ..io.generate import orbit_camera
        rm = tree.config.RaymarchParams(coarse_seed=True)
        scene, ro, rd, _ = M[name]
        H, W = FRAME
        cone = tree.raymarch_cuda.cone_seed_cuda
        if route == "planes":
            return lambda: tuple(cone(scene, rm, ro, rd))
        cam = orbit_camera(0.25, device=ro.device)
        if route == "alone":
            # the march launch alone, on the camera glue's cones
            from ..ops import raymarch
            cones = raymarch.cone_rays_analytic(
                cam, tree.config.CameraParams(width=W, height=H), 0, 0, H, W)
            return lambda: (tree.raymarch_cuda.cone_launch(scene, *cones,
                                                           rm),)
        scale, window = (2, (H, W)) if route == "quarter" else (1, (0, 0))
        cfg = tree.config.CameraParams(width=scale * W, height=scale * H)
        return lambda: tuple(cone(scene, rm, camera=cam, cam_cfg=cfg,
                                  window=window, shape=(H, W)))

    for name, _ in SCENES:
        for route in ("camera", "quarter", "planes", "alone"):
            yield (f"K15 {name} {route}",
                   lambda t, name=name, route=route: k15(t, name, route))

    def k12(tree, r, sigma_n, odd=False, depth=None):
        # chip_smoke.py phase 3's planes (the albedo a plane of its own);
        # "odd": sides one and three short of the frame's
        cfg = tree.config
        p = cfg.FilterParams(type=cfg.FilterType.CROSS, radius=r,
                             sigma_normal=sigma_n, depth=depth or 1)
        planes = (c, T["frame"]["h_color"], n, z)
        if odd:
            H, W = z.shape
            planes = tuple(x[..., :H - 1, :W - 3].contiguous()
                           for x in planes)
        if depth:
            g = tree.GBuffer(render=planes[0], albedo=planes[1],
                             normal=planes[2], depth=planes[3])
            return lambda: (tree.filters.apply_filter(g, p).denoised,)
        return lambda: (tree.filters_cuda.cross_bilateral_cuda(*planes,
                                                               params=p),)

    for r in (0, 1, 2, 3, 4, 5, 8, 16, 40):
        for sigma_n in (128.0, 100.0):
            yield (f"K12 r{r} sigma_n {sigma_n:g}",
                   lambda t, r=r, sigma_n=sigma_n: k12(t, r, sigma_n))
    # past r 16, the taps in a device array (an earlier tree than 3dccd34
    # refuses them)
    for r in (17, 24):
        yield (f"K12w r{r} sigma_n 128", lambda t, r=r: k12(t, r, 128.0))
    yield "K12w r17 odd frame", lambda t: k12(t, 17, 128.0, odd=True)
    for r in (2, 4):
        yield (f"K12 r{r} odd frame",
               lambda t, r=r: k12(t, r, 128.0, odd=True))
    yield "K12 apply_filter depth 2", lambda t: k12(t, 2, 128.0, depth=2)

    def smooth(tree, ftype, r, depth, sigma=2.0, odd=False, apply=False):
        # K10 (AVERAGE) and K11 (GAUSSIAN) on chip_smoke.py phase 3's
        # colour planes; "odd": sides one and three short of the frame's
        x = c
        if odd:
            H, W = c.shape[-2:]
            x = c[..., :H - 1, :W - 3].contiguous()
        if apply:
            cfg = tree.config
            p = cfg.FilterParams(type=getattr(cfg.FilterType, ftype),
                                 radius=r, sigma_space=sigma, depth=depth)
            g = tree.GBuffer(render=x, albedo=T["frame"]["h_color"],
                             normal=n, depth=z)
            return lambda: (tree.filters.apply_filter(g, p).denoised,)
        if ftype == "AVERAGE":
            return lambda: (tree.filters_cuda.box_filter_cuda(
                x, radius=r, depth=depth),)
        return lambda: (tree.filters_cuda.gaussian_filter_cuda(
            x, radius=r, sigma=sigma, depth=depth),)

    # K10 at depth 1 (r 0-4 the 2-D body, from BOX_PASS_RADIUS the 1-D
    # passes; a tree before them ran a 2-D body to r 16), at depth 2
    # across the crossover,
    # deeper (r2 d5 past the halo cap), on the odd frame and through
    # apply_filter.  Where this tree runs the passes and the other the 2-D
    # body (dy-major, dx-minor), within rounding; the twin's floats, bit
    # for bit, in the twin cases
    def box_exact(r):
        return r < BOX_PASS_RADIUS

    box_cases = ([(r, 1) for r in (0, 1, 2, 3) + ROUTE_RADII]
                 + [(r, 2) for r in ROUTE_RADII] + [(1, 3), (2, 3), (2, 5)])
    for r, d in box_cases:
        yield (f"K10 r{r} d{d}",
               lambda t, r=r, d=d: smooth(t, "AVERAGE", r, d), box_exact(r))
    for d in (1, 3):
        yield (f"K10 r2 d{d} odd frame",
               lambda t, d=d: smooth(t, "AVERAGE", 2, d, odd=True))
    yield ("K10 apply_filter depth 2",
           lambda t: smooth(t, "AVERAGE", 2, 2, apply=True))
    # K11 at five radii and three sigmas, and across the crossover at
    # sigma r / 2; its 2-D body and its passes add the twin's products in
    # the twin's order: bit-equal to the other tree either way
    k11_cases = [(r, sigma) for r in (0, 1, 2, 4, 16)
                 for sigma in (0.5, 2.0, 8.0)] + [
                     (r, r / 2.0) for r in ROUTE_RADII if r not in (4, 16)]
    for r, sigma in k11_cases:
        for d in (1, 2):
            yield (f"K11 r{r} sigma {sigma:g} d{d}",
                   lambda t, r=r, sigma=sigma, d=d: smooth(
                       t, "GAUSSIAN", r, d, sigma))
    for d in (1, 2):
        yield (f"K11 r2 sigma 2 d{d} odd frame",
               lambda t, d=d: smooth(t, "GAUSSIAN", 2, d, odd=True))

    def smooth_twin(ftype, r, sigma, d=1, exact=True):
        def launch(tree):
            if ftype == "AVERAGE":
                from ..ops.boxfilter import box_filter
                return lambda: (box_filter(c, radius=r, depth=d),)
            return lambda: (tree.filters.gaussian_filter(
                c, radius=r, sigma=sigma, depth=d),)
        # the passes add their twin's terms in its order: held exactly;
        # K10's 2-D body within rounding (the JAX package's tolerance)
        return (Twin(launch, rtol=0.0, atol=0.0) if exact
                else Twin(launch, relative=False))

    # K10 across the crossover against its twin
    for r in ROUTE_RADII:
        for d in (1, 2):
            yield (f"K10 r{r} d{d} twin",
                   lambda t, r=r, d=d: smooth(t, "AVERAGE", r, d),
                   smooth_twin("AVERAGE", r, 2.0, d, not box_exact(r)))
    # past r 16 (the passes in both trees since 3dccd34): held to the other
    # tree at depth 1 and 2, on the odd frame and at a radius past the
    # frame's height, and to this tree's twin
    for r, d, odd in ((17, 1, False), (24, 1, False), (90, 1, False),
                      (17, 2, False), (17, 1, True), (90, 1, True),
                      (WIDE_PAST_FRAME, 1, False)):
        where = " odd frame" if odd else f" d{d}"
        yield (f"K10w r{r}{where}",
               lambda t, r=r, d=d, odd=odd: smooth(t, "AVERAGE", r, d,
                                                   odd=odd))
        yield (f"K11w r{r} sigma {r / 2:g}{where}",
               lambda t, r=r, d=d, odd=odd: smooth(t, "GAUSSIAN", r, d,
                                                   r / 2.0, odd=odd))
    for r in (17, 24, 90):
        yield (f"K10w r{r} d1 twin",
               lambda t, r=r: smooth(t, "AVERAGE", r, 1),
               smooth_twin("AVERAGE", r, 2.0))
        yield (f"K11w r{r} sigma {r / 2:g} d1 twin",
               lambda t, r=r: smooth(t, "GAUSSIAN", r, 1, r / 2.0),
               smooth_twin("GAUSSIAN", r, r / 2.0))
    yield ("K11 apply_filter depth 2",
           lambda t: smooth(t, "GAUSSIAN", 2, 2, apply=True))
    for r in (0, 1, 2, 3):
        for wm in ("exact", "fast"):
            yield (f"sweep r{r} {wm} (phase 3)",
                   lambda t, r=r, wm=wm: lambda: tuple(
                       t.atrous_cuda.svgf_spatial_cuda(
                           c, v, n, z, params=t.SVGFParams(radius=r),
                           weight_math=wm, return_feedback=True)))


def compare(a, b):
    """(all outputs bit-equal, largest |a - b|)."""
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    diff = max(float((x.float() - y.float()).abs().max()) for x, y in
               zip(a, b))
    return equal, diff


_ATROUS = re.compile(r"(level_kernel(_2b)?|wgrad\w*kernel|atrous\w*kernel|"
                     r"shade_kernel|march_kernel|shadow_kernel|"
                     r"temporal(_bwd)?_kernel|cone\w*kernel|"
                     r"cross_bilateral\w*kernel|"
                     r"(clamped_)?gather\w*kernel|round_planes_kernel|"
                     r"box\w*kernel|gauss\w*kernel|pass_[xy]_kernel)"
                     r"(I\w*?EE)?")


def resources(text_or_dict):
    """``{short kernel name: (registers, stack, spill st, spill ld)}`` of
    the à-trous, march, shading, shadow, temporal, cone, box, gaussian (and
    their 1-D passes), cross-bilateral and clamped-gather kernels in a
    ptxas report (a kernel that is not a template by its name alone)."""
    out = {}
    for name, res in text_or_dict.items():
        m = _ATROUS.search(name)
        if m:
            out[m.group(0)] = res
    return out


def _spread(ms):
    """(max - min) / median of one tree's times."""
    return (max(ms) - min(ms)) / float(np.median(ms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the results as JSON here")
    ap.add_argument("--only", default=None,
                    help="run the cases whose name matches this regex")
    ap.add_argument("--rounds", type=int, default=2,
                    help="time this tree, then the other, this many times "
                         "(0: compare the outputs only)")
    ap.add_argument("--device-time", action="store_true",
                    help="time a call by its device time under the "
                         "profiler (kernels and memsets), not by CUDA "
                         "events around back-to-back calls")
    ap.add_argument("--by-kernel", action="store_true",
                    help="print each tree's device time a call by kernel "
                         "(and memset or fill) under the profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(nvidia_smi_name_power(), flush=True)
    load_tree(args.parent.resolve(), "rdt_other")
    this, other = Tree(PACKAGE), Tree("rdt_other")
    report = {}
    for label, tree in (("this", this), ("other", other)):
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                lib = tree.build.build(verbose=True)
        except RuntimeError:
            print(log.getvalue(), flush=True)
            raise
        tree.build.kernels()
        report[label] = resources(parse_resources(log.getvalue()))
        print(f"{label}: built {lib}", flush=True)
        for name, (regs, frame, st, ld) in sorted(report[label].items()):
            print(f"  {label} {name}: {regs} registers, stack {frame} B, "
                  f"spills {st + ld} B")

    H, W = FRAME
    P = planes(H, W, dev, 0)
    g = torch.Generator(dev).manual_seed(11)
    cots = (torch.randn((3, H, W), generator=g, device=dev),
            torch.randn((H, W), generator=g, device=dev))
    U = planes(2 * H, 2 * W, dev, 12) + ((
        torch.randn((3, 2 * H, 2 * W), generator=g, device=dev),
        torch.randn((2 * H, 2 * W), generator=g, device=dev)),)
    rows, bad = [], []

    def time(f):
        if args.device_time:
            return device_ms(f, REPEATS)
        return cuda_time_ms(f, repeats=REPEATS)

    with torch.no_grad():
        S = shade_inputs(dev)
        M = march_inputs(dev, other)
        T = temporal_inputs(dev)
        for name, make, exact in cases(P, U, cots, S, M, T):
            if args.only and not re.search(args.only, name):
                continue
            twin = isinstance(exact, Twin)
            fa = make(this)
            fb = exact.launch(this) if twin else make(other)
            a, b = fa(), fb()
            equal, diff = compare(a, b)
            if twin:
                ok = exact.close(a, b)
            else:
                # an output compared within rounding: KGb's tolerance
                # against its float64 twin (rtol 1e-5, atol 1e-6·max)
                exacts = (exact if isinstance(exact, tuple)
                          else (exact,) * len(a))
                ok = all(torch.equal(x, y) or not ex and torch.allclose(
                    x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()))
                    for x, y, ex in zip(a, b, exacts))
            # a twin is the CPU oracle run on the card: only the kernel
            # is timed
            ms = [time(f) for _ in range(args.rounds)
                  for f in ((fa,) if twin else (fa, fb))]
            mine, theirs = (ms, []) if twin else (ms[0::2], ms[1::2])
            rows.append(dict(case=name, equal=equal, ok=ok, max_diff=diff,
                             ms_this=mine, ms_other=theirs,
                             other="this tree's twin" if twin else "other"))
            verdict = ("bit-equal" if equal else "within rounding" if ok
                       else "DIFFERS") + (" to the twin" if twin else "")
            if twin:
                print(f"{name}: {verdict} (max |diff| {diff:.3g})" + (
                    f"; ms this {' '.join(f'{t:.4f}' for t in mine)}, "
                    f"median {np.median(mine):.4f}" if ms else ""),
                    flush=True)
            else:
                print(f"{name}: {verdict} (max |diff| {diff:.3g})" + (
                    f"; ms this {' '.join(f'{t:.4f}' for t in mine)}, other "
                    f"{' '.join(f'{t:.4f}' for t in theirs)}, ratio "
                    f"{sum(mine) / sum(theirs):.3f}" if ms else "") + (
                        f", medians {np.median(mine):.4f} / "
                        f"{np.median(theirs):.4f} (spread "
                        f"{_spread(mine):.1%} / {_spread(theirs):.1%})"
                        if args.rounds > 2 else ""), flush=True)
            if args.by_kernel:
                for label, f in ((("this", fa),) if twin else
                                 (("this", fa), ("other", fb))):
                    split = device_ms_by_kernel(f, REPEATS)
                    print(f"  {label} by kernel: " + ", ".join(
                        f"{k[:60]} {v:.4f}" for k, v in sorted(
                            split.items(), key=lambda kv: -kv[1])),
                        flush=True)
            if not ok:
                bad.append(name)
            del fa, fb
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=nvidia_smi_name_power(), resources=report, cases=rows),
            indent=1))
    n_equal = sum(row["equal"] for row in rows)
    print(f"kernel_ab: {n_equal} of {len(rows)} cases bit-equal, "
          f"{len(rows) - len(bad)} as required" +
          (f"; differ: {bad}" if bad else ""), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
