"""Profile the training step, the serving frame or the spatial sweep's
forward and backward on one GPU.

    python3 -m raymarchdenoisercuda_torch.utils.profile train   # config 4
    python3 -m raymarchdenoisercuda_torch.utils.profile serve   # config 3
    python3 -m raymarchdenoisercuda_torch.utils.profile serve --seeded
    python3 -m raymarchdenoisercuda_torch.utils.profile serve --unbounded
    python3 -m raymarchdenoisercuda_torch.utils.profile spatial --mode recompute
    python3 -m raymarchdenoisercuda_torch.utils.profile clamped
    python3 -m raymarchdenoisercuda_torch.utils.profile temporal [--served]
    python3 -m raymarchdenoisercuda_torch.utils.profile box
    python3 -m raymarchdenoisercuda_torch.utils.profile forms
    python3 -m raymarchdenoisercuda_torch.utils.profile sass [--match RE]

At 1920x1080: runs 3 warm-up steps, times ``--steps`` more without the
profiler, then traces as many with ``torch.profiler`` (CPU and CUDA
activities) and prints: the card's name and power limit, the wall time per
step, the device-busy time per step (the sum of the kernels' device time;
overlapping kernels would count twice, and the port runs one stream), the
busy share of the wall, and the ``--top`` operators and kernels with the
most device time.  ``--seeded`` serves with ``RaymarchParams(coarse_seed=
True)`` (the cone seed from the camera, K15, and the seeded march);
``--unbounded`` with ``SVGFParams(max_motion=None)`` (K3's unbounded
step: the clamped gather in K3's body).

``clamped`` times the clamped gather (KG) and its adjoint (KGb) alone, by
kernel (device time a call under the profiler, ``--steps`` calls), on
``chip_smoke.py`` phase 3's input (uniform random motion to ±28 pixels)
and on a served frame's (the ninth orbit frame through ``FramePipeline``
with ``max_motion=None``), the history stacked channel-minor by KGp as the
differentiable unbounded step stacks it: the stack's build (KGp, and the planar ``cat``
of ``history_stack`` that the bounded paths make), KG, and KGb with both
gradients, with the history's only and with the motion's only, each split
into its kernels, memsets and fills.  ``temporal`` profiles
``chip_smoke.py`` phase 6's gradient pass, ``svgf_denoise_frame(temporal=
"ad")`` forward and backward with respect to motion and the history's
colour (K4, then K5) on seeded planes with uniform random motion to ±6
pixels or, with ``--served``, on the served frame's inputs (the ninth
orbit frame's).  ``box`` times K10 (``box_filter_cuda``) on three
seeded 1920x1080 planes, by device time a call (``--steps`` calls under
the profiler), at each radius and depth of ``BOX_CASES`` and each way of
splitting its levels into launches that a halo cap in ``BOX_CAPS`` gives
(cap 0: one level a launch), the ways in turn three times, and prints
the medians: the measurement behind ``BOX_HALO_CAP``.  ``forms`` times
the à-trous adjoints K14 and K2/K2b (bf16 and float weights, K1b's, on
``_spatial_runner``'s planes) at each radius of ``FORMS_RADII`` and each
level of ``FORMS_LEVELS`` in both forms, staged (where its tile fits a
block) and with the centres read through the caches, by device time a
call, the forms in turn ``FORMS_ROUNDS`` times, and prints the medians
beside the staged tile's size and the form ``utils.tiling.adjoint_staged``
picks: the measurement behind the adjoints' staging budgets.  ``sass`` builds
the kernels, disassembles the library with ``cuobjdump -sass`` and
prints, for each kernel whose mangled name matches ``--match`` (default:
the bf16 forms of K1b and K14), its instruction count by class (MUFU,
conversions, PRMT, packed half/bf16 arithmetic, float arithmetic, shared
and global loads, branches, ...), and that count over the kernel's taps
(the tap loops are unrolled, so the whole function's count over its
(2r + 1)^2 taps approximates a tap's; the staging and epilogue are in
it too).  ``--trace DIR``
(train, serve, spatial, temporal) also writes the profiled steps as a
Chrome trace, ``DIR/<path>.json`` (``timing.trace``).  Needs a CUDA
device; the CPU has nothing to measure here.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..gbuffer import History
from ..io.generate import orbit_camera
from ..models.pipeline import (FramePipeline, init_train_state,
                               make_train_step)
from ..ops import filters_cuda, raymarch
from ..ops.atrous import sigma_denominator
from ..ops.atrous_cuda import (atrous_level_bwd_cuda,
                               atrous_level_bwd_stored_cuda,
                               atrous_level_fwd_cuda, svgf_spatial_ad_cuda)
from ..ops.common import finite_diff_gradients
from ..ops.cuda import _build
from ..ops.temporal import history_from_stack, history_stack
from ..ops.temporal_cuda import (clamped_gather_bwd_cuda, clamped_gather_cuda,
                                 history_stack_channel_minor_cuda)
from . import tiling
from .seeded_inputs import clamped_inputs, served_clamped_inputs
from .timing import device_ms_by_kernel, nvidia_smi_name_power, trace


def _train_runner(H, W, dev):
    scene = raymarch.cornell_scene(device=dev)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    step = make_train_step(scene, raymarch.cornell_camera(device=dev),
                           target, cam_cfg=CameraParams(width=W, height=H),
                           rm_params=RaymarchParams(),
                           svgf_params=SVGFParams(iterations=5, radius=1))
    state = [init_train_state(scene.materials.albedo, H, W,
                              torch.Generator(dev).manual_seed(0))]

    def run():
        state[0], _ = step(state[0])
    return run


def _serve_runner(H, W, dev, seeded=False, unbounded=False):
    scene = raymarch.cornell_scene(device=dev)
    svgf = (SVGFParams(radius=1, max_motion=None) if unbounded
            else SVGFParams(radius=1))
    pipe = FramePipeline(scene, CameraParams(width=W, height=H),
                         RaymarchParams(coarse_seed=seeded), svgf,
                         weight_math="fast")
    gen = torch.Generator(dev).manual_seed(0)
    carry = {"hist": History.zeros(H, W, device=dev), "prev": None, "f": 0}

    def run():
        cam = orbit_camera(carry["f"] / 16, device=dev)
        _, carry["hist"] = pipe(cam, carry["prev"], carry["hist"], gen)
        carry["prev"] = cam
        carry["f"] += 1
    return run


# the adjoint modes of svgf_spatial_ad_cuda, as chip_smoke.py's phase 9
SPATIAL_MODES = {"stored": dict(bwd_impl="stored"),
                 "stored_f32": dict(bwd_impl="stored_f32"),
                 "recompute": dict(bwd_impl="recompute"),
                 "weight_grads": dict(weight_grads=True)}


def _spatial_planes(H, W, dev):
    """Seeded colour, variance, normal and depth."""
    g = torch.Generator(dev).manual_seed(9)
    normal = torch.nn.functional.normalize(
        torch.randn((3, H, W), generator=g, device=dev)
        + torch.tensor([0.0, 0.0, 3.0], device=dev)[:, None, None], dim=0)
    return (torch.rand((3, H, W), generator=g, device=dev),
            0.02 * torch.rand((H, W), generator=g, device=dev), normal,
            0.3 + 0.5 * torch.rand((H, W), generator=g, device=dev))


def _spatial_runner(H, W, dev, mode, radius):
    """The 5-level sweep forward and backward, exact weights, on seeded
    planes (colour, variance, and with ``weight_grads`` normal and depth
    differentiated)."""
    planes = _spatial_planes(H, W, dev)
    kw = SPATIAL_MODES[mode]
    diff = 4 if kw.get("weight_grads") else 2
    params = SVGFParams(iterations=5, radius=radius)

    def run():
        ins = [t.detach().requires_grad_(k < diff)
               for k, t in enumerate(planes)]
        c, v, fb = svgf_spatial_ad_cuda(*ins, params=params,
                                        return_feedback=True, **kw)
        torch.autograd.grad(c.sum() + v.sum() + fb.sum(), ins[:diff])
    return run


def _temporal_runner(H, W, dev, served):
    """Phase 6's K5 pass: the denoised frame's mean square differentiated
    with respect to the motion and the history's colour through
    ``svgf_denoise_frame(temporal="ad")`` (config 4's SVGF)."""
    from ..gbuffer import GBuffer
    from ..models.svgf import svgf_denoise_frame
    from .seeded_inputs import served_inputs
    params = SVGFParams(iterations=5, radius=1)
    if served:
        gbuf, hist = served_inputs(H, W, dev)
    else:
        rng = np.random.default_rng(5)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        n = rng.standard_normal((3, H, W))
        n[2] += 3.0
        n /= np.sqrt((n ** 2).sum(0, keepdims=True))
        color, depth = t(rng.random((3, H, W))), t(0.3 + 0.5 * rng.random(
            (H, W)))
        gbuf = GBuffer(render=color, albedo=torch.full_like(color, 0.7),
                       normal=t(n), depth=depth,
                       motion=t((rng.random((2, H, W)) - 0.5) * 12.0))
        hist = History(color=t(rng.random((3, H, W))),
                       moments=t(rng.random((2, H, W))),
                       length=t(np.floor(rng.random((H, W)) * 6)),
                       prev_depth=depth, prev_normal=gbuf.normal)

    def run():
        m = gbuf.motion.detach().requires_grad_()
        hc = hist.color.detach().requires_grad_()
        out, _ = svgf_denoise_frame(gbuf.replace(motion=m),
                                    hist.replace(color=hc), params=params,
                                    temporal="ad")
        (out.denoised ** 2).mean().backward()
    return run


def clamped_split(stack, motion, g, calls):
    """``[(what, {kernel: ms})]``: KG and KGb (both gradients, the history's
    only, the motion's only) on one input, by kernel."""
    runs = [("KG", lambda: clamped_gather_cuda(stack, motion))]
    for hg, mg, what in ((True, True, "KGb"), (True, False, "KGb history"),
                         (False, True, "KGb motion")):
        runs.append((what, lambda hg=hg, mg=mg: clamped_gather_bwd_cuda(
            stack, motion, g, history_grad=hg, motion_grad=mg)))
    return [(what, device_ms_by_kernel(fn, calls)) for what, fn in runs]


def _clamped(H, W, dev, calls):
    for label, (stack, motion, g) in (
            ("random motion ±28 px", clamped_inputs(H, W, dev)),
            ("served frame", served_clamped_inputs(H, W, dev))):
        hist = history_from_stack(stack)
        runs = [("stack KGp", device_ms_by_kernel(
                    lambda: history_stack_channel_minor_cuda(hist), calls)),
                ("stack cat (planar)", device_ms_by_kernel(
                    lambda: history_stack(hist), calls))]
        runs += clamped_split(history_stack_channel_minor_cuda(hist), motion,
                              g, calls)
        for what, split in runs:
            parts = ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(
                split.items(), key=lambda kv: -kv[1]))
            print(f"{label}: {what} {sum(split.values()):.4f} ms a call "
                  f"(device): {parts}", flush=True)


# K10's (radius, depth) cases and halo caps for ``box``
BOX_CASES = ((0, 3), (1, 2), (1, 3), (1, 4), (1, 6), (1, 8), (2, 2), (2, 3),
             (2, 4), (2, 5), (3, 2), (3, 3), (4, 2), (4, 3))
BOX_CAPS = (0, 2, 4, 6, 8, 12, 16)
BOX_ROUNDS = 3


def _box(H, W, dev, calls):
    x = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    for r, depth in BOX_CASES:
        # the groupings the caps give, each with the smallest cap
        ways = {}
        for cap in BOX_CAPS:
            ways.setdefault(tuple(filters_cuda.box_level_groups(
                r, depth, cap)), cap)
        ms = {g: [] for g in ways}
        for _ in range(BOX_ROUNDS):
            for g in ways:
                ms[g].append(sum(device_ms_by_kernel(
                    lambda: filters_cuda._box_launches(x, r, g),
                    calls).values()))
        print(f"K10 r{r} d{depth}, device ms a call (median of "
              f"{BOX_ROUNDS}): " + "; ".join(
                  f"launches {list(g)} (cap {cap}) {np.median(ms[g]):.4f}"
                  for g, cap in ways.items()), flush=True)


# forms: the adjoints' radii and levels timed in both forms, and rounds
FORMS_RADII = (1, 2, 3, 4, 5, 8)
FORMS_LEVELS = tuple(range(8))
FORMS_ROUNDS = 3


def _device_ms(fn, calls, tries=3):
    """Device ms a call of ``fn`` (``device_ms_by_kernel`` summed); a
    profiler session that caught no kernel is run again."""
    for _ in range(tries):
        ms = sum(device_ms_by_kernel(fn, calls).values())
        if ms > 0.0:
            return ms
    raise RuntimeError("the profiler caught no kernel")


def _forms(H, W, dev, calls):
    c, v, n, z = _spatial_planes(H, W, dev)
    g = torch.Generator(dev).manual_seed(10)
    gc = torch.randn((3, H, W), generator=g, device=dev)
    gv = torch.randn((H, W), generator=g, device=dev)
    zg = finite_diff_gradients(z)
    for r in FORMS_RADII:
        params = SVGFParams(radius=r)
        sd = sigma_denominator(v, params)
        for lvl in FORMS_LEVELS:
            _, _, norm, w = atrous_level_fwd_cuda(
                c, v, n, z, zg, sd, level=lvl, params=params,
                save_weights=True)
            wb = w.to(torch.bfloat16)
            launches = {
                "K14": lambda st: atrous_level_bwd_cuda(
                    c, n, z, zg, sd, norm, gc, gv, level=lvl, params=params,
                    staged=st),
                "K2": lambda st: atrous_level_bwd_stored_cuda(
                    wb, norm, gc, gv, level=lvl, radius=r, staged=st),
                "K2b": lambda st: atrous_level_bwd_stored_cuda(
                    w, norm, gc, gv, level=lvl, radius=r, staged=st)}
            for kn, f in launches.items():
                key = "K14" if kn == "K14" else "K2"
                rows, cols = tiling.staged_tile(r, lvl)
                nbytes = rows * cols * tiling.STAGED_PIXEL_BYTES[key]
                forms = ((True, False) if r and nbytes
                         <= tiling.SMEM_PER_BLOCK else (False,))
                ms = {st: [] for st in forms}
                for _ in range(FORMS_ROUNDS):
                    for st in forms:
                        ms[st].append(_device_ms(lambda st=st: f(st), calls))
                med = {st: float(np.median(t)) for st, t in ms.items()}
                default = tiling.adjoint_staged(key, r, lvl)
                print(f"{kn} r{r} l{lvl}: staged tile {nbytes / 1024:.1f} "
                      f"KB, picks {'staged' if default else 'the caches'}; "
                      f"device ms a call (median of {FORMS_ROUNDS}): "
                      + (f"staged {med[True]:.4f}, " if True in med else "")
                      + f"through the caches {med[False]:.4f}"
                      + (f", ratio {med[True] / med[False]:.3f}"
                         if True in med else ""), flush=True)
            del w, wb, norm


# SASS opcodes by class (the base opcode, before its first dot)
SASS_CLASSES = (
    ("MUFU", ("MUFU",)),
    ("convert", ("F2I", "I2F", "F2F", "F2FP", "I2FP", "F2IP", "FRND")),
    ("PRMT", ("PRMT",)),
    ("half2", ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "HSETP2", "HSET2")),
    ("float", ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK",
               "FSET")),
    ("LDS", ("LDS", "LDSM")),
    ("LDG", ("LDG", "LD")),
    ("STG/STS", ("STG", "STS", "ST")),
    ("branch", ("BRA", "BSSY", "BSYNC", "BREAK", "CALL", "RET", "EXIT",
                "WARPSYNC", "BAR", "BMOV", "JMP")),
    ("integer", ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL",
                 "IABS", "IMNMX", "VIADDMNMX", "VIMNMX", "IADD",
                 "VIADD", "UIMAD", "UIADD3", "ULOP3", "USHF", "ULEA",
                 "UISETP", "USEL")),
)
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                          r"([A-Z][A-Z0-9_]*)")
# the bf16 forms: level_bf16_kernel<R, ...> (K1b-bf16) and
# atrous_bwd_bf16_kernel<R, STAGED> (K14-bf16); R = -1: any radius
BF16_FORMS = r"level_bf16_kernel|atrous_bwd_bf16_kernel"
_TEMPLATE_R = re.compile(r"_kernelILi(n?\d+)E")


def sass_mix(match: str = BF16_FORMS, lib: Path = None) -> dict:
    """``{mangled name: Counter(class -> static instruction count)}`` of
    the library's kernels whose name matches ``match``, from ``cuobjdump
    -sass`` (streamed: the whole listing is tens of MiB)."""
    lib = lib or _build.build()
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    want = re.compile(match)
    out, current = {}, None
    proc = subprocess.Popen([str(tool), "-sass", str(lib)],
                            stdout=subprocess.PIPE, text=True)
    for line in proc.stdout:
        m = _SASS_FUNCTION.search(line)
        if m:
            name = m.group(1)
            current = (out.setdefault(name, collections.Counter())
                       if want.search(name) else None)
            continue
        if current is None:
            continue
        m = _SASS_OPCODE.search(line)
        if m:
            op = m.group(1)
            cls = next((c for c, ops in SASS_CLASSES if op in ops), "other")
            current[cls] += 1
            current["total"] += 1
    if proc.wait() != 0:
        raise RuntimeError(f"{tool} -sass {lib} failed")
    return out


def sass_taps(name: str) -> int:
    """The taps of a kernel compiled at radius R (the template's first
    argument; 0 where it takes its radius at run time)."""
    m = _TEMPLATE_R.search(name)
    R = int(m.group(1).replace("n", "-")) if m else -1
    return (2 * R + 1) ** 2 if R >= 0 else 0


def sass_lines(match: str = BF16_FORMS, lib: Path = None):
    """One printable line a matching kernel: its instruction classes and,
    at a compiled radius, each class over the taps."""
    order = ["total"] + [c for c, _ in SASS_CLASSES] + ["other"]
    for name, mix in sorted(sass_mix(match, lib).items()):
        taps = sass_taps(name)
        parts = ", ".join(f"{c} {mix[c]}" + (f" ({mix[c] / taps:.1f})"
                                             if taps else "")
                          for c in order if mix[c])
        yield (f"{name}: {parts}" + (f"  [(...) a tap of {taps}]"
                                     if taps else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", choices=("train", "serve", "spatial", "clamped",
                                     "temporal", "box", "forms", "sass"))
    ap.add_argument("--match", default=BF16_FORMS,
                    help="sass: the kernels' mangled names to count")
    ap.add_argument("--mode", choices=tuple(SPATIAL_MODES),
                    default="stored", help="spatial: the adjoint mode")
    ap.add_argument("--radius", type=int, default=1, help="spatial: radius")
    ap.add_argument("--seeded", action="store_true",
                    help="serve: with the cone seed (coarse_seed)")
    ap.add_argument("--unbounded", action="store_true",
                    help="serve: with SVGFParams(max_motion=None)")
    ap.add_argument("--served", action="store_true",
                    help="temporal: on the served frame's inputs")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="train, serve, spatial, temporal: write the "
                         "profiled steps as a Chrome trace into DIR")
    args = ap.parse_args(argv)
    if args.path == "sass":
        for line in sass_lines(args.match):
            print(line, flush=True)
        return 0
    if args.trace and args.path in ("clamped", "box", "forms", "sass"):
        ap.error(f"--trace: {args.path} times its kernels under a profiler "
                 f"of its own")
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    H, W = 1080, 1920
    if args.path in ("clamped", "box", "forms"):
        print(nvidia_smi_name_power())
        with torch.no_grad():
            {"clamped": _clamped, "box": _box, "forms": _forms}[args.path](
                H, W, dev, args.steps)
        return 0
    if args.path == "spatial":
        run = _spatial_runner(H, W, dev, args.mode, args.radius)
    elif args.path == "serve":
        run = _serve_runner(H, W, dev, args.seeded, args.unbounded)
    elif args.path == "temporal":
        run = _temporal_runner(H, W, dev, args.served)
    else:
        run = _train_runner(H, W, dev)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    what = (f"spatial {args.mode} r{args.radius}" if args.path == "spatial"
            else args.path + " seeded" * args.seeded
            + " unbounded" * args.unbounded if args.path == "serve"
            else args.path + " served" * args.served
            if args.path == "temporal" else args.path)
    with (trace(args.trace, what.replace(" ", "_")) if args.trace else
          profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA])) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels only: an operator's row repeats the time of its kernels
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / args.steps
    print(nvidia_smi_name_power())
    print(f"{what} {W}x{H}: wall {wall:.3f} ms/step unprofiled; device "
          f"busy {busy:.3f} ms/step under the profiler "
          f"({100 * busy / wall:.1f} % of the unprofiled wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
