"""The à-trous level kernels of this tree against another tree's, on one GPU.

    python3 -m raymarchdenoisercuda_torch.utils.kernel_ab --parent DIR \\
        [--out build/kernel_ab.json]

``DIR`` holds another checkout of the repository (an earlier commit,
unpacked with ``git archive``).  Its package is imported beside this one
under another name, each builds its kernels from its own sources into its
own ``build/``, and both run in this one process on the same inputs:
K1 (every radius 0-3, fast, exact and luminance-only weights, at every
level 0-4, with no store and with bf16 and float weight stores), K1b (with
and without float weights), K9, the tile forms of K1/K1b on a quarter tile
of a 3840x2160 frame at levels 1 and 4, and the 5-level inference sweep as
``chip_smoke.py`` phase 3 runs it, all at 1920x1080 on seeded planes.  For
each case it prints whether every output is bit-equal to the other tree's
(``torch.equal``) and the largest difference, and times both trees in turn
with CUDA events (this, other, this, other; 20 launches each).  It prints
ptxas's registers, stack and spills of the à-trous kernels of each tree it
builds (a library built before is loaded as it is), and the card's name
and power limit.  It exits non-zero if an output differs.
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


def cases(P, U, cots):
    """``(name, fn)``: ``fn(tree)`` is a zero-argument launch returning a
    tuple of tensors."""
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
        uc, uv, un, uz = U
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
        return lambda: tuple(fn.atrous_level_cuda(
            cc, vc, nc, dc, zgr, weight_math="fast", **kw))

    for kind in ("K1 fast", "K1 store", "K1b"):
        for r in (1, 2):
            for lvl in (1, 4):
                yield (f"tile {kind} r{r} l{lvl}",
                       lambda t, kind=kind, r=r, lvl=lvl: tile(t, kind, r,
                                                                 lvl))
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


_ATROUS = re.compile(r"(level_kernel(_2b)?|wgrad\w*kernel|atrous\w*kernel)I"
                     r"\w*?EE")


def resources(text_or_dict):
    """``{short kernel name: (registers, stack, spill st, spill ld)}`` of
    the à-trous kernels in a ptxas report."""
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

    P = planes(1080, 1920, dev, 0)
    U = planes(2160, 3840, dev, 12)
    g = torch.Generator(dev).manual_seed(11)
    cots = (torch.randn((3, 1080, 1920), generator=g, device=dev),
            torch.randn((1080, 1920), generator=g, device=dev))
    rows, bad = [], []
    with torch.no_grad():
        for name, make in cases(P, U, cots):
            if args.only and not re.search(args.only, name):
                continue
            fa, fb = make(this), make(other)
            equal, diff = compare(fa(), fb())
            ms = [cuda_time_ms(f, repeats=REPEATS) for f in (fa, fb, fa, fb)]
            rows.append(dict(case=name, equal=equal, max_diff=diff,
                             ms_this=ms[0::2], ms_other=ms[1::2]))
            print(f"{name}: {'bit-equal' if equal else 'DIFFERS'} (max "
                  f"|diff| {diff:.3g}); ms this {ms[0]:.4f} {ms[2]:.4f}, "
                  f"other {ms[1]:.4f} {ms[3]:.4f}, ratio "
                  f"{(ms[0] + ms[2]) / (ms[1] + ms[3]):.3f}", flush=True)
            if not equal:
                bad.append(name)
            del fa, fb
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=nvidia_smi_name_power(), resources=report, cases=rows),
            indent=1))
    print(f"kernel_ab: {len(rows) - len(bad)} of {len(rows)} cases "
          f"bit-equal" + (f"; differ: {bad}" if bad else ""), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
