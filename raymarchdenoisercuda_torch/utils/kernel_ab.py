"""The redesigned kernels of this tree against another tree's, on one GPU.

    python3 -m raymarchdenoisercuda_torch.utils.kernel_ab --parent DIR \\
        [--out build/kernel_ab.json] [--only REGEX]

``DIR`` holds another checkout of the repository (an earlier commit,
unpacked with ``git archive``).  Its package is imported beside this one
under another name, each builds its kernels from its own sources into its
own ``build/``, and both run in this one process on the same inputs:
K1 (every radius 0-3, fast, exact and luminance-only weights, at every
level 0-4, with no store and with bf16 and float weight stores), K1b (with
and without float weights), K9, K14 (every radius 0-3 at every level 0-4),
the tile forms of K1/K1b/K14 on a quarter tile of a 3840x2160 frame at
levels 1 and 4, and the 5-level inference sweep as ``chip_smoke.py`` phase
3 runs it, all at 1920x1080 on seeded planes; K8 on the G-buffers of the
Cornell box, ``random_scene`` and a scene of other primitive counts (its
runtime-count instantiation), with ``relax_omega`` 1.0 and 1.5, with and
without the previous camera, and on a window of the frame (the sharded
path's launch); and KGb, the clamped gather's adjoint, whose float64 sum
is compared to within rounding, not bit for bit.  For each case it prints
whether every output is bit-equal to the other tree's (``torch.equal``)
and the largest difference, and times both trees in turn with CUDA events
(this, other, this, other; 20 launches each).  It prints ptxas's
registers, stack and spills of the à-trous and shading kernels of each
tree it builds (a library built before is loaded as it is), and the
card's name and power limit.  It exits non-zero if an output of a
bit-equal case differs, or if KGb's differs by more than rtol 1e-5.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda._build import parse_resources
from .timing import cuda_time_ms, nvidia_smi_name_power

PACKAGE = "raymarchdenoisercuda_torch"
REPEATS = 20
FRAME = (1080, 1920)                 # the main paths' frame (H, W)


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


# K8's scenes: the two it is compiled for, and one of other counts
SHADE_SCENES = (("cornell", {}), ("random", dict(seed=3)),
                ("odd", dict(n_spheres=7, n_boxes=4, seed=5)))


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
    for name, kw in SHADE_SCENES:
        scene = (raymarch.cornell_scene(device=dev) if name == "cornell"
                 else raymarch.random_scene(device=dev, **kw))
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


def cases(P, U, cots, S):
    """``(name, fn, exact)``: ``fn(tree)`` is a zero-argument launch
    returning a tuple of tensors; ``exact``: the two trees' outputs must be
    bit-equal (else within rounding)."""
    for case in _cases(P, U, cots, S):
        yield case if len(case) == 3 else case + (True,)


def _cases(P, U, cots, S):
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

    for r in (0, 1, 2, 3):
        for lvl in range(5):
            yield (f"K14 r{r} l{lvl}",
                   lambda t, r=r, lvl=lvl: k14(t, r, lvl))

    for kind in ("K1 fast", "K1 store", "K1b", "K14"):
        for r in (1, 2):
            for lvl in (1, 4):
                yield (f"tile {kind} r{r} l{lvl}",
                       lambda t, kind=kind, r=r, lvl=lvl: tile(t, kind, r,
                                                                 lvl))

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

    for name, _ in SHADE_SCENES:
        for omega in (1.0, 1.5):
            for prev in (True, False):
                yield (f"K8 {name} omega {omega}"
                       f"{'' if prev else ' no prev'}",
                       lambda t, name=name, omega=omega, prev=prev: k8(
                           t, name, omega, prev, False))
        yield (f"K8 {name} window",
               lambda t, name=name: k8(t, name, 1.0, True, True))

    def kgb(tree):
        # chip_smoke.py phase 3's inputs: motion to ±28 pixels
        rng = np.random.default_rng(13)
        dev = c.device
        stack = torch.from_numpy(rng.random((10, *FRAME),
                                            dtype=np.float32)).to(dev)
        motion = torch.from_numpy(((rng.random((2, *FRAME)) - 0.5)
                                   * 56.0).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((10, *FRAME)).astype(
            np.float32)).to(dev)
        g[6:] = 0.0
        return lambda: tuple(tree.temporal_cuda.clamped_gather_bwd_cuda(
            stack, motion, g))

    yield "KGb (within rounding)", kgb, False
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
                     r"shade_kernel)I\w*?EE")


def resources(text_or_dict):
    """``{short kernel name: (registers, stack, spill st, spill ld)}`` of
    the à-trous and shading kernels in a ptxas report."""
    out = {}
    for name, res in text_or_dict.items():
        m = _ATROUS.search(name)
        if m:
            out[m.group(0)] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the results as JSON here")
    ap.add_argument("--only", default=None,
                    help="run the cases whose name matches this regex")
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
    with torch.no_grad():
        S = shade_inputs(dev)
        for name, make, exact in cases(P, U, cots, S):
            if args.only and not re.search(args.only, name):
                continue
            fa, fb = make(this), make(other)
            a, b = fa(), fb()
            equal, diff = compare(a, b)
            # a case compared within rounding: KGb's tolerance against its
            # float64 twin (rtol 1e-5, atol 1e-6·max)
            ok = equal or not exact and all(
                torch.allclose(x, y, rtol=1e-5,
                               atol=1e-6 * float(y.abs().max()))
                for x, y in zip(a, b))
            ms = [cuda_time_ms(f, repeats=REPEATS) for f in (fa, fb, fa, fb)]
            rows.append(dict(case=name, equal=equal, ok=ok, max_diff=diff,
                             ms_this=ms[0::2], ms_other=ms[1::2]))
            verdict = ("bit-equal" if equal else "within rounding" if ok
                       else "DIFFERS")
            print(f"{name}: {verdict} (max |diff| {diff:.3g}); ms this "
                  f"{ms[0]:.4f} {ms[2]:.4f}, other {ms[1]:.4f} {ms[3]:.4f}, "
                  f"ratio {(ms[0] + ms[2]) / (ms[1] + ms[3]):.3f}",
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
