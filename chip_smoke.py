#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (each prints lines starting with its number; any failure raises and
the script exits non-zero without printing a result):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``raymarchdenoisercuda_torch/ops/cuda/*.cu``
   (one nvcc per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   1080p shapes of the main paths, values and gradients, and time both
   with CUDA events: K1 à-trous level (inference and store mode), K2
   stored-weight adjoint, K3 temporal step, K4 reprojection gather, K5/K6
   its adjoints (with ``grid_sample``'s forward and backward timed beside
   them as the library yardstick), K7 march, K8 shadow + shading, K10 box
   filter (``avg_pool2d`` beside it), K11 gaussian (a depthwise
   ``conv2d`` beside it), K12 cross-bilateral filter, K13 shadow
   visibility (Cornell box and ``random_scene``);
4. the serving path: 16 frames of the animated Cornell sequence at
   1920x1080 (``orbit_camera``) through ``FramePipeline`` (render ->
   temporal -> 5-level à-trous, radius 1, fast weights); the first 3
   frames match the plain path;
5. the training step (BASELINE config 4): ``make_train_step`` at
   1920x1080 on the Cornell scene, radius 1, 5 levels, exact weights,
   Adam at lr 1e-2 against a seeded target; 1 warm-up and 8 timed steps
   (ms/step, peak memory); the first 2 steps match the plain path;
6. the temporal gradient path: ``svgf_denoise_frame(temporal="ad")`` at
   1080p differentiated with respect to motion and history, with the motion
   gradient (K5) and without it (K6); gradients match the plain path;
7. the reference's own surface: the CLI's ``-t`` case runner
   (``raymarchdenoisercuda_torch.cli``) on the 1920x1080 filter, spatial,
   temporal, raymarch and device cases, on the card;
8. the dataset: ``generate_sequence`` writes 2 frames at 1920x1080 and
   16 light samples a pixel (K7, then K13 once a sample), read back with
   ``load_float_frame`` (exactly) and ``load_frame`` (to the PNGs'
   quantisation); frame 0 matches the plain path's render from the same
   seed; ``apply_filter`` runs all four filter types on the loaded frame,
   kernel path against plain path.

Phases 4 to 8 are the main paths: every kernel's launch count is set to 0
just before each and read just after, and each fails if one of its
kernels never launched.  The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
No JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from raymarchdenoisercuda_torch import cli
from raymarchdenoisercuda_torch.config import (
    CameraParams, FilterParams, FilterType, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io import load_frame
from raymarchdenoisercuda_torch.io.generate import (
    generate_sequence, load_float_frame, orbit_camera)
from raymarchdenoisercuda_torch.models.pipeline import (
    FramePipeline, init_train_state, make_train_step)
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import (atrous, boxfilter, filters,
                                            raymarch, temporal)
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level_bwd_stored_cuda, atrous_level_cuda, svgf_spatial_cuda)
from raymarchdenoisercuda_torch.ops.common import finite_diff_gradients
from raymarchdenoisercuda_torch.ops.cuda import _build
from raymarchdenoisercuda_torch.ops.filters_cuda import (
    box_filter_cuda, cross_bilateral_cuda, gaussian_filter_cuda)
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    march_gbuf_cuda, shadow_factor_cuda, shadow_shade_cuda)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    gather_bwd_cuda, gather_bwd_hist_cuda, gather_cuda,
    temporal_accumulate_cuda)
from raymarchdenoisercuda_torch.utils.timing import (
    CudaTimer, cuda_time_ms, nvidia_smi_name_power)

SEQ_FRAMES = 16
CHECK_FRAMES = 3
SERVING = SVGFParams(radius=1)       # the adopted mode: radius 1 ...
SERVING_WEIGHTS = "fast"             # ... with fast tap weights
TRAIN = SVGFParams(iterations=5, radius=1)   # config 4, exact weights
TRAIN_STEPS = 8                      # timed, after one warm-up step
CHECK_STEPS = 2
DATA_FRAMES = 2                      # phase 8: frames and light samples
DATA_SPP = 16
CLI_CASES = ("FILTER_BASELINE|FILTER_TILED|FILTER_CROSS|SVGF_SPATIAL|"
             "RAYMARCH|TEMPORAL|DEVICE_STATS")
M = SVGFParams().max_motion
# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
WRAPPERS = {"K1": atrous_level_cuda, "K2": atrous_level_bwd_stored_cuda,
            "K3": temporal_accumulate_cuda, "K4": gather_cuda,
            "K5": gather_bwd_cuda, "K6": gather_bwd_hist_cuda,
            "K7": march_gbuf_cuda, "K8": shadow_shade_cuda,
            "K10": box_filter_cuda, "K11": gaussian_filter_cuda,
            "K12": cross_bilateral_cuda, "K13": shadow_factor_cuda}
PALLAS = "raymarchdenoisercuda_tpu/ops/pallas/"
CUDA_SRC = "raymarchdenoisercuda_torch/ops/cuda/"
KERNELS = {
    "K1": ("atrous_level", CUDA_SRC + "atrous.cu",
           PALLAS + "atrous_tpu.py:172"),
    "K2": ("atrous_bwd_stored", CUDA_SRC + "atrous.cu",
           PALLAS + "atrous_tpu.py:361"),
    "K3": ("temporal_step", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:57"),
    "K4": ("reproject_gather", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:446"),
    "K5": ("reproject_gather_bwd", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:606"),
    "K6": ("reproject_gather_bwd_hist", CUDA_SRC + "temporal.cu",
           PALLAS + "temporal_tpu.py:518"),
    "K7": ("march_gbuf", CUDA_SRC + "raymarch.cu",
           PALLAS + "raymarch_tpu.py:115"),
    "K8": ("shadow_shade", CUDA_SRC + "raymarch.cu",
           PALLAS + "raymarch_tpu.py:468"),
    "K10": ("box_level", CUDA_SRC + "filters.cu", PALLAS + "box_tpu.py:53"),
    "K11": ("gauss_pass", CUDA_SRC + "filters.cu",
            PALLAS + "filters_tpu.py:41"),
    "K12": ("cross_bilateral", CUDA_SRC + "filters.cu",
            PALLAS + "filters_tpu.py:135"),
    "K13": ("shadow_visibility", CUDA_SRC + "raymarch.cu",
            PALLAS + "raymarch_tpu.py:408"),
}
# per-tap float operations of K1's weight math and accumulation, of K2's
# tap and of K12's tap (weights, three colour products, the sums), counted
# from the kernel sources (a transcendental counts as one)
K1_TAP_FLOPS = 40
K2_TAP_FLOPS = 14
K12_TAP_FLOPS = 37


def phase(n, msg):
    print(f"phase {n}: {msg}", flush=True)


def max_err(a, b, mask=None):
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, got, want, *, atol, rtol=0.0, mask=None):
    """Raise unless |got - want| <= atol + rtol·|want| (where ``mask``)."""
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol={atol:.3g} rtol={rtol:.3g} (max |diff| "
            f"{float((got - want).abs().max()):.3g})")


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_planes(H, W, dev, seed):
    """Seeded SVGF inputs of the main paths' shapes."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return dict(color=t(rng.random((3, H, W))),
                variance=t(0.02 * rng.random((H, W))), normal=t(n),
                depth=t(0.3 + 0.5 * rng.random((H, W))),
                motion=t((rng.random((2, H, W)) - 0.5) * 14.0),
                h_color=t(rng.random((3, H, W))),
                h_moments=t(rng.random((2, H, W))),
                h_length=t(np.floor(rng.random((H, W)) * 6)))


def check_k1(P, results):
    args = (P["color"], P["variance"], P["normal"], P["depth"])
    HW = P["depth"].numel()
    for radius in (1, 2):
        for wm in ("exact", "fast"):
            params = SVGFParams(radius=radius)
            got = svgf_spatial_cuda(*args, params=params, weight_math=wm,
                                    return_feedback=True)
            want = atrous.svgf_spatial_ref(*args, params=params,
                                           weight_math=wm,
                                           return_feedback=True)
            for name, a, b in zip(("color", "variance", "feedback"), got,
                                  want):
                tol = (dict(atol=0.0, rtol=5e-5) if wm == "exact"
                       else dict(atol=2e-4 * float(b.abs().max())))
                check_close(f"K1 r{radius} {wm} {name}", a, b, **tol)
            err = max(max_err(a, b) for a, b in zip(got, want))
            ms = cuda_time_ms(lambda: svgf_spatial_cuda(
                *args, params=params, weight_math=wm), repeats=10)
            plain_ms = cuda_time_ms(lambda: atrous.svgf_spatial_ref(
                *args, params=params, weight_math=wm), repeats=3)
            phase(3, f"K1 r{radius} {wm}: ok, max |err| {err:.3g}, "
                     f"{ms:.4f} ms/sweep (5 levels), plain {plain_ms:.4f} ms")
            if radius == SERVING.radius and wm == SERVING_WEIGHTS:
                # inputs 10 floats a pixel, outputs 4
                results["K1"] = dict(
                    max_abs_err=err, ms=ms / SERVING.iterations,
                    plain_ms=plain_ms / SERVING.iterations,
                    bytes=56 * HW, flops=K1_TAP_FLOPS * 9 * HW)


def check_k1_store_k2(P, results):
    """K1 in store mode (values, bf16 weights, N) and K2 on its weights,
    each level against the plain twins on the same inputs."""
    color, var, normal, depth = (P["color"], P["variance"], P["normal"],
                                 P["depth"])
    zgrad = finite_diff_gradients(depth)
    H, W = depth.shape
    HW = H * W
    g = torch.Generator(color.device).manual_seed(1)
    gc = torch.randn((3, H, W), generator=g, device=color.device)
    gv = torch.randn((H, W), generator=g, device=color.device)
    for radius in (1, 2):
        taps = (2 * radius + 1) ** 2
        for wm in ("exact", "fast"):
            params = SVGFParams(radius=radius)
            c, v = color, var
            errs = [0.0, 0.0]
            for level in range(params.iterations):
                kw = dict(level=level, params=params, weight_math=wm)
                got = atrous_level_cuda(c, v, normal, depth, zgrad,
                                        store=True, **kw)
                want = atrous.atrous_level_ref(c, v, normal, depth, zgrad,
                                               return_weights=True, **kw)
                w_want = want[2].to(torch.bfloat16)
                for name, a, b in (("color", got[0], want[0]),
                                   ("variance", got[1], want[1]),
                                   ("N", got[3], want[3])):
                    tol = (dict(atol=0.0, rtol=5e-5) if wm == "exact"
                           else dict(atol=2e-4 * float(b.abs().max())))
                    check_close(f"K1 store r{radius} {wm} l{level} {name}",
                                a, b, **tol)
                # one bf16 step: expf/torch.exp (or the fast polynomial's
                # seams) can put a weight on either side of a rounding
                check_close(f"K1 store r{radius} {wm} l{level} weights",
                            got[2], w_want, atol=1e-30, rtol=2.0 ** -7)
                errs[0] = max(errs[0], max_err(got[2], w_want))
                k2 = atrous_level_bwd_stored_cuda(got[2], got[3], gc, gv,
                                                  level=level, radius=radius)
                k2_want = atrous.atrous_level_bwd_stored_ref(
                    got[2], got[3], gc, gv, level=level, radius=radius)
                for name, a, b in zip(("d_color", "d_variance"), k2,
                                      k2_want):
                    check_close(f"K2 r{radius} {wm} l{level} {name}", a, b,
                                atol=1e-12 * float(b.abs().max()),
                                rtol=1e-6)
                errs[1] = max(errs[1], max(max_err(a, b)
                                           for a, b in zip(k2, k2_want)))
                c, v = want[0], want[1]
            lvl_args = (color, var, normal, depth, zgrad)
            kw = dict(level=0, params=params, weight_math=wm)
            ms = cuda_time_ms(lambda: atrous_level_cuda(
                *lvl_args, store=True, **kw), repeats=20)
            plain_ms = cuda_time_ms(lambda: atrous.atrous_level_ref(
                *lvl_args, return_weights=True, **kw), repeats=3)
            w, norm = got[2], got[3]
            ms2 = cuda_time_ms(lambda: atrous_level_bwd_stored_cuda(
                w, norm, gc, gv, level=0, radius=radius), repeats=20)
            plain2 = cuda_time_ms(lambda: atrous.atrous_level_bwd_stored_ref(
                w, norm, gc, gv, level=0, radius=radius), repeats=3)
            phase(3, f"K1 store r{radius} {wm}: ok (5 levels), max |err| "
                     f"weights {errs[0]:.3g}, {ms:.4f} ms/level, plain "
                     f"{plain_ms:.4f} ms; K2: ok, max |err| {errs[1]:.3g}, "
                     f"{ms2:.4f} ms/level, plain {plain2:.4f} ms")
            if radius == TRAIN.radius and wm == "exact":
                # bf16 weights, N, gc, gv in; dc, dv out
                results["K2"] = dict(
                    max_abs_err=errs[1], ms=ms2, plain_ms=plain2,
                    bytes=(2 * taps + 4 + 12 + 4 + 16) * HW,
                    flops=K2_TAP_FLOPS * taps * HW)


def check_k3(P, results):
    g = GBuffer(render=P["color"], albedo=P["color"], normal=P["normal"],
                depth=P["depth"], motion=P["motion"])
    h = History(color=P["h_color"], moments=P["h_moments"],
                length=P["h_length"], prev_depth=P["depth"],
                prev_normal=P["normal"])
    params = SVGFParams()
    got = temporal_accumulate_cuda(g, h, params=params)
    want = temporal.temporal_accumulate(g, h, params=params)
    pairs = [("integrated", got[0], want[0]), ("variance", got[1], want[1]),
             ("moments", got[2].moments, want[2].moments)]
    for name, a, b in pairs:
        check_close(f"K3 {name}", a, b, atol=1e-6, rtol=1e-5)
    check_close("K3 length", got[2].length, want[2].length, atol=0.0)
    err = max(max_err(a, b) for _, a, b in pairs)
    ms = cuda_time_ms(lambda: temporal_accumulate_cuda(g, h, params=params),
                      repeats=20)
    plain_ms = cuda_time_ms(lambda: temporal.temporal_accumulate(
        g, h, params=params), repeats=3)
    # render, motion, depth, normal, 10 history planes in; 7 planes out;
    # ~60 flops a pixel, and ~8 a tap of the 7x7 window on the pixels
    # whose new history is short (this input's share)
    short = float((got[2].length < params.variance_boost_frames).float()
                  .mean())
    HW = g.depth.numel()
    results["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bytes=104 * HW, flops=(60 + 49 * 8 * short) * HW)
    phase(3, f"K3: ok, max |err| {err:.3g}, {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms")


def _grid(motion):
    """``grid_sample`` coordinates of p + motion (align_corners=True)."""
    H, W = motion.shape[-2:]
    iy = torch.arange(H, device=motion.device, dtype=torch.float32)[:, None]
    ix = torch.arange(W, device=motion.device, dtype=torch.float32)[None, :]
    gx = (ix + motion[1]) * (2.0 / (W - 1)) - 1.0
    gy = (iy + motion[0]) * (2.0 / (H - 1)) - 1.0
    return torch.stack([gx, gy], -1)[None]


def check_k4_k5_k6(P, results):
    dev = P["color"].device
    H, W = P["depth"].shape
    HW = H * W
    rng = np.random.default_rng(4)
    stack = torch.cat([P["h_color"], P["h_moments"], P["h_length"][None],
                       P["depth"][None], P["normal"]]).contiguous()
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    rand = (rng.random((2, H, W)) - 0.5) * 2 * (M + 1)   # some beyond M
    motions = {"random": rand, "integer": np.round(rand),
               "zero": np.zeros((2, H, W))}
    tol = dict(atol=1e-6, rtol=1e-5)
    errs = [0.0, 0.0, 0.0]
    for kind, m in motions.items():
        motion = torch.from_numpy(m.astype(np.float32)).to(dev)
        a, b = gather_cuda(stack, motion, M), temporal.gather_ref(
            stack, motion, M)
        check_close(f"K4 {kind}", a, b, **tol)
        errs[0] = max(errs[0], max_err(a, b))
        k5 = gather_bwd_cuda(stack, motion, g, M, grad_planes=6)
        want = temporal.gather_bwd_ref(stack, motion, g, M, motion_grad=True,
                                       grad_planes=6)
        for name, a, b in zip(("d_hist", "d_motion"), k5, want):
            check_close(f"K5 {kind} {name}", a, b, **tol)
        errs[1] = max(errs[1], max(max_err(a, b) for a, b in zip(k5, want)))
        k6 = gather_bwd_hist_cuda(motion, g, M, grad_planes=6)
        check_close(f"K6 {kind} d_hist", k6[0], want[0], **tol)
        errs[2] = max(errs[2], max_err(k6[0], want[0]))
        if float(k6[1].abs().max()) != 0.0:
            raise AssertionError("K6: nonzero d_motion")
    motion = torch.from_numpy(motions["random"].astype(np.float32)).to(dev)
    inside = ((motion[0].abs() <= M) & (motion[1].abs() <= M)).float().mean()
    # a within pixel reads its <= 4 taps; count the pixels this input has
    frac = float(inside)
    ms4 = cuda_time_ms(lambda: gather_cuda(stack, motion, M), repeats=20)
    plain4 = cuda_time_ms(lambda: temporal.gather_ref(stack, motion, M),
                          repeats=3)
    ms5 = cuda_time_ms(lambda: gather_bwd_cuda(stack, motion, g, M,
                                               grad_planes=6), repeats=20)
    ms6 = cuda_time_ms(lambda: gather_bwd_hist_cuda(motion, g, M,
                                                    grad_planes=6),
                       repeats=20)
    plain5 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
        stack, motion, g, M, motion_grad=True, grad_planes=6), repeats=3)
    plain6 = cuda_time_ms(lambda: temporal.gather_bwd_ref(
        None, motion, g, M, motion_grad=False, grad_planes=6), repeats=3)
    # library yardstick: bilinear grid_sample with zero padding
    x = stack[None].clone().requires_grad_()
    grid = _grid(motion).requires_grad_()
    lib4 = cuda_time_ms(lambda: F.grid_sample(
        x, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        repeats=20)
    y = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
    gy = g[None]
    lib5 = cuda_time_ms(lambda: torch.autograd.grad(
        y, (x, grid), gy, retain_graph=True), repeats=20)
    lib6 = cuda_time_ms(lambda: torch.autograd.grad(
        y, x, gy, retain_graph=True), repeats=20)
    results["K4"] = dict(max_abs_err=errs[0], ms=ms4, plain_ms=plain4,
                         library_ms=lib4, bytes=88 * HW,
                         flops=int(4 * (10 * 2 + 8) * frac * HW))
    results["K5"] = dict(max_abs_err=errs[1], ms=ms5, plain_ms=plain5,
                         library_ms=lib5, bytes=104 * HW,
                         flops=int((4 * 6 * 2 + 9 * (6 * 2 + 12))
                                   * frac * HW))
    results["K6"] = dict(max_abs_err=errs[2], ms=ms6, plain_ms=plain6,
                         library_ms=lib6, bytes=72 * HW,
                         flops=int(4 * 6 * 2 * frac * HW))
    phase(3, f"K4/K5/K6: ok on random, integer and zero motion, max |err| "
             f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}; K4 {ms4:.4f} ms "
             f"(plain {plain4:.4f}, grid_sample {lib4:.4f}); K5 {ms5:.4f} ms "
             f"(plain {plain5:.4f}, grid_sample bwd {lib5:.4f}); K6 "
             f"{ms6:.4f} ms (plain {plain6:.4f}, grid_sample bwd input-only "
             f"{lib6:.4f})")


def check_filters(P, results):
    """K10, K11 and K12 against their plain twins on the 1080p planes."""
    x = P["color"]
    HW = P["depth"].numel()
    # K10 at the FILTER_TILED / apply_filter(AVERAGE) configuration and a
    # deeper one; avg_pool2d computes the same function, a call a level
    errs = []
    for r, depth in ((2, 1), (1, 3)):
        got = box_filter_cuda(x, radius=r, depth=depth)
        want = boxfilter.box_filter(x, radius=r, depth=depth)
        check_close(f"K10 r{r} d{depth}", got, want, atol=1e-6, rtol=1e-5)
        errs.append(max_err(got, want))

    def pool():
        return F.avg_pool2d(x[None], 5, stride=1, padding=2,
                            count_include_pad=False)[0]

    check_close("avg_pool2d vs K10's twin", pool(),
                boxfilter.box_filter(x, radius=2, depth=1), atol=1e-6,
                rtol=1e-5)
    ms = cuda_time_ms(lambda: box_filter_cuda(x, radius=2, depth=1),
                      repeats=20)
    plain = cuda_time_ms(lambda: boxfilter.box_filter(x, radius=2, depth=1),
                         repeats=5)
    lib = cuda_time_ms(pool, repeats=20)
    # 3 planes in, 3 out; 25 adds a channel and a division
    results["K10"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                          library_ms=lib, bytes=24 * HW, flops=78 * HW)
    phase(3, f"K10: ok (r2 d1, r1 d3), max |err| {max(errs):.3g}, {ms:.4f} "
             f"ms (r2 d1), plain {plain:.4f} ms, avg_pool2d {lib:.4f} ms")

    # K11: r2 sigma 2 at depth 1 and 2; the yardstick is one depthwise
    # conv2d with the 2-D gaussian (the numerator only: no border
    # renormalisation), in full float32
    errs = []
    for depth in (1, 2):
        got = gaussian_filter_cuda(x, radius=2, sigma=2.0, depth=depth)
        want = filters.gaussian_filter(x, radius=2, sigma=2.0, depth=depth)
        check_close(f"K11 depth {depth}", got, want, atol=1e-5)
        errs.append(max_err(got, want))
    taps = torch.tensor(filters._gauss_taps(2, 2.0), device=x.device)
    w2 = (taps[:, None] * taps[None, :]).expand(3, 1, 5, 5).contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lib = cuda_time_ms(lambda: F.conv2d(x[None], w2, padding=2, groups=3),
                       repeats=20)
    torch.backends.cudnn.allow_tf32 = tf32
    ms = cuda_time_ms(lambda: gaussian_filter_cuda(x, radius=2, sigma=2.0),
                      repeats=20)
    plain = cuda_time_ms(lambda: filters.gaussian_filter(x, radius=2,
                                                         sigma=2.0), repeats=5)
    # an iteration: 3 planes in, 3 out; two passes of 5 taps (a product and
    # two sums) and a division
    results["K11"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                          library_ms=lib, bytes=24 * HW, flops=96 * HW)
    phase(3, f"K11: ok (depth 1, 2), max |err| {max(errs):.3g}, {ms:.4f} ms "
             f"an iteration (2 launches), plain {plain:.4f} ms, depthwise "
             f"conv2d (numerator only) {lib:.4f} ms")

    # K12 at FilterParams(CROSS): r2, sigma_n 128 (repeated squaring)
    p = FilterParams(type=FilterType.CROSS)
    albedo = P["h_color"]
    args = (x, albedo, P["normal"], P["depth"])
    got = cross_bilateral_cuda(*args, params=p)
    want = filters.cross_bilateral_filter(*args, params=p)
    check_close("K12", got, want, atol=5e-5)
    err = max_err(got, want)
    ms = cuda_time_ms(lambda: cross_bilateral_cuda(*args, params=p),
                      repeats=20)
    plain = cuda_time_ms(lambda: filters.cross_bilateral_filter(
        *args, params=p), repeats=3)
    # colour, albedo, normal, depth in (40 B), colour out (12 B)
    results["K12"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bytes=52 * HW, flops=K12_TAP_FLOPS * 25 * HW)
    phase(3, f"K12: ok, max |err| {err:.3g}, {ms:.4f} ms, plain "
             f"{plain:.4f} ms")


def sdf_flops(scene):
    """Float operations of one scene SDF evaluation in K7/K8 (sphere 10,
    box 22, plane 6, plus one compare each)."""
    return (11 * scene.sphere_params.shape[0] + 23 * scene.box_params.shape[0]
            + 7 * scene.plane_params.shape[0])


def march_evals(scene, ro, rd, rm):
    """SDF evaluations K7 makes on these rays: the steps each ray takes
    before it stops, one at the hit and six for the normal."""
    t = torch.zeros(ro.shape[1:], device=ro.device)
    steps = torch.zeros_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for _ in range(rm.max_steps):
        d = raymarch.sdf_scene(scene, ro + t[None] * rd, want_mat=False)
        steps += alive.float()
        alive = alive & (d > rm.hit_eps) & (t < rm.max_dist)
        if not bool(alive.any()):
            break
        t = t + torch.where(alive, d, torch.zeros_like(d))
    return float((steps + 7.0).sum())


def shadow_evals(scene, p, n, light_p, hit, rm):
    """SDF evaluations of K8's shadow march on these inputs."""
    origin = p + 0.02 * n
    to_l = light_p - origin
    dist_l = torch.sqrt((to_l * to_l).sum(0))
    ld = to_l / torch.clamp(dist_l, min=1e-8)[None]
    dist_l = torch.where(hit, dist_l, torch.zeros_like(dist_l))
    t = torch.zeros_like(dist_l)
    steps = torch.zeros_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for _ in range(rm.shadow_steps):
        d = raymarch.sdf_scene(scene, origin + t[None] * ld, want_mat=False)
        steps += alive.float()
        alive = alive & (d > rm.hit_eps) & (t < dist_l - 0.02)
        if not bool(alive.any()):
            break
        t = t + torch.where(alive, torch.clamp(d, min=0.01),
                            torch.zeros_like(d))
    return float(steps.sum())


def check_k7_k8(H, W, dev, results):
    scene = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
    HW = H * W

    got = march_gbuf_cuda(scene, ro, rd, rm)
    want = raymarch.march_gbuf(scene, ro, rd, rm)
    # a pixel whose hit or material flips on an ulp (an exact tie between
    # two primitives) is left out: at most 0.1 % of the frame
    same = (got[1] == want[1]) & (got[2] == want[2])
    if float((~same).float().mean()) > 1e-3:
        raise AssertionError(f"K7: {int((~same).sum())} hit/material flips")
    check_close("K7 t", got[0], want[0], atol=1e-4, mask=same)
    check_close("K7 normal", got[3], want[3], atol=5e-4, rtol=5e-3,
                mask=same)
    err7 = max(max_err(got[0], want[0], same), max_err(got[3], want[3], same))
    ms = cuda_time_ms(lambda: march_gbuf_cuda(scene, ro, rd, rm), repeats=10)
    plain_ms = cuda_time_ms(lambda: raymarch.march_gbuf(scene, ro, rd, rm),
                            repeats=2)
    # ro, rd in; t, hit (1 byte), material, normal out
    results["K7"] = dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                         bytes=45 * HW,
                         flops=march_evals(scene, ro, rd, rm)
                         * sdf_flops(scene) + 20 * HW)
    phase(3, f"K7: ok, {int((~same).sum())} flips, max |err| {err7:.3g}, "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K8 on the plain march's outputs, so both versions see one input
    t, hit, mat, n = want
    p = ro + t[None] * rd
    alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.float()[None]
    alb, em = alb * hit_f, em * hit_f
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    light = raymarch.light_constants(scene)
    prev = raymarch.prev_camera_constants(orbit_camera(0.1875, device=dev),
                                          cfg)
    args = (scene, p, n, lp, alb, em, hit, light, prev, rm, (W, H))
    got = shadow_shade_cuda(*args)
    want = raymarch.shadow_shade(*args)
    same = got[1] == want[1]            # visibility flips, as above
    if float((~same).float().mean()) > 1e-3:
        raise AssertionError(f"K8: {int((~same).sum())} visibility flips")
    check_close("K8 render", got[0], want[0], atol=1e-4, mask=same)
    check_close("K8 motion", got[2], want[2], atol=1e-4)
    err8 = max(max_err(got[0], want[0], same), max_err(got[2], want[2]))
    ms = cuda_time_ms(lambda: shadow_shade_cuda(*args), repeats=10)
    plain_ms = cuda_time_ms(lambda: raymarch.shadow_shade(*args), repeats=2)
    # p, n, light sample, albedo, emission, hit in; render, vis, motion out
    results["K8"] = dict(max_abs_err=err8, ms=ms, plain_ms=plain_ms,
                         bytes=85 * HW,
                         flops=shadow_evals(scene, p, n, lp, hit, rm)
                         * sdf_flops(scene) + 80 * HW)
    phase(3, f"K8: ok, {int((~same).sum())} flips, max |err| {err8:.3g}, "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms")


def check_k13(H, W, dev, results):
    """K13 against its plain twin at 1080p on the hit points of both
    scenes (every pixel marches: K13 has no hit mask)."""
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    HW = H * W
    for name, scene in (("cornell", raymarch.cornell_scene(device=dev)),
                        ("random", raymarch.random_scene(device=dev))):
        ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
        t, _hit, _mat, n = march_gbuf_cuda(scene, ro, rd, rm)
        p = ro + t[None] * rd
        lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(2),
                                   (H, W))
        got = shadow_factor_cuda(scene, p, n, lp, rm)
        want = raymarch.shadow_factor(scene, p, n, lp, rm)
        flips = int((got != want).sum())
        if flips > 1e-3 * HW:
            raise AssertionError(f"K13 {name}: {flips} visibility flips")
        ms = cuda_time_ms(lambda: shadow_factor_cuda(scene, p, n, lp, rm),
                          repeats=10)
        plain = cuda_time_ms(lambda: raymarch.shadow_factor(
            scene, p, n, lp, rm), repeats=2)
        phase(3, f"K13 {name}: ok, {flips} flips, lit {float(got.mean()):.3f}"
                 f", {ms:.4f} ms, plain {plain:.4f} ms")
        if name == "cornell":
            # p, n, light sample in; vis out; the shadow march's SDF
            # evaluations on these inputs
            everywhere = torch.ones((H, W), dtype=torch.bool, device=dev)
            results["K13"] = dict(
                max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain, bytes=40 * HW,
                flops=shadow_evals(scene, p, n, lp, everywhere, rm)
                * sdf_flops(scene) + 20 * HW)


def reset_counts():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_counts(n, expected):
    """The launch counts of a main path's run; fail if one of its kernels
    never launched."""
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase {n}: kernels never launched on the "
                             f"main path: {missing}")
    return counts


def run_sequence(pipe, n_frames, H, W, dev, keep):
    """Render + denoise ``n_frames`` orbit frames; returns the per-frame
    device times (ms) and the first ``keep`` denoised frames."""
    gen = torch.Generator(dev).manual_seed(0)
    hist = History.zeros(H, W, device=dev)
    prev, times, kept = None, [], []
    for f in range(n_frames):
        cam = orbit_camera(f / SEQ_FRAMES, device=dev)
        with CudaTimer() as tm:
            out, hist = pipe(cam, prev, hist, gen)
        times.append(tm.ms)
        if not bool(torch.isfinite(out.denoised).all()):
            raise AssertionError(f"frame {f}: non-finite denoised values")
        if out.denoised.shape != (3, H, W):
            raise AssertionError(f"frame {f}: shape {out.denoised.shape}")
        if f < keep:
            kept.append(out.denoised.clone())
        prev = cam
    return times, kept


def serving_phase(H, W, dev, n_frames):
    scene = raymarch.cornell_scene(device=dev)
    pipe_cfg = dict(cam_cfg=CameraParams(width=W, height=H),
                    rm_params=RaymarchParams(), svgf_params=SERVING,
                    weight_math=SERVING_WEIGHTS)
    kernel_pipe = FramePipeline(scene, impl="auto", **pipe_cfg)
    plain_pipe = FramePipeline(scene, impl="plain", **pipe_cfg)
    keep = min(CHECK_FRAMES, n_frames)
    reset_counts()
    times, kernel_frames = run_sequence(kernel_pipe, n_frames, H, W, dev,
                                        keep)
    counts = read_counts(4, ("K1", "K3", "K7", "K8"))
    plain_times, plain_frames = run_sequence(plain_pipe, keep, H, W, dev,
                                             keep)
    for f, (a, b) in enumerate(zip(kernel_frames, plain_frames)):
        check_close(f"frame {f} denoised (kernel vs plain)", a, b,
                    atol=1e-3 * float(b.abs().max()))
    steady = times[1:] or times
    phase(4, f"{n_frames} frames {W}x{H}: kernel path "
             f"{sum(times) / len(times):.3f} ms/frame (frames 2-{n_frames}:"
             f" {sum(steady) / len(steady):.3f}), plain path "
             f"{sum(plain_times) / len(plain_times):.3f} ms/frame over "
             f"{keep}; first {keep} frames match; launches {counts}")
    return counts


def run_train(step, state, n_steps, keep):
    """``n_steps`` train steps; returns per-step device ms, host ms, and
    (loss, albedo gradient, albedo) of the first ``keep``."""
    dev_ms, host_ms, kept = [], [], []
    for k in range(n_steps):
        t0 = time.perf_counter()
        with CudaTimer() as tm:
            state, loss = step(state)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(tm.ms)
        if not bool(torch.isfinite(loss)) or not bool(
                torch.isfinite(state.albedo.grad).all()):
            raise AssertionError(f"train step {k}: non-finite loss/gradient")
        if k < keep:
            kept.append((float(loss), state.albedo.grad.clone(),
                         state.albedo.detach().clone()))
    return state, dev_ms, host_ms, kept


def train_phase(H, W, dev):
    scene = raymarch.cornell_scene(device=dev)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H),
              rm_params=RaymarchParams(), svgf_params=TRAIN)
    cam = raymarch.cornell_camera(device=dev)
    runs = {}
    for impl in ("auto", "plain"):
        step = make_train_step(scene, cam, target, impl=impl, **kw)
        state = init_train_state(scene.materials.albedo, H, W,
                                 torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if impl == "auto":
            reset_counts()
            n = 1 + TRAIN_STEPS
        else:
            n = CHECK_STEPS
        state, dev_ms, host_ms, kept = run_train(step, state, n, CHECK_STEPS)
        peak = torch.cuda.max_memory_allocated() - base
        if impl == "auto":
            counts = read_counts(5, ("K1", "K2", "K4", "K7", "K8"))
            dev_ms, host_ms = dev_ms[1:], host_ms[1:]
        runs[impl] = (dev_ms, host_ms, kept, peak)
        del step, state
    for k, (a, b) in enumerate(zip(runs["auto"][2], runs["plain"][2])):
        if abs(a[0] - b[0]) > 1e-5 * abs(b[0]):
            raise AssertionError(f"train step {k}: loss {a[0]} vs plain "
                                 f"{b[0]}")
        # the kernel path's adjoint multiplies the bf16-stored weights
        check_close(f"train step {k} albedo gradient", a[1], b[1],
                    atol=3e-3 * float(b[1].abs().max()))
        check_close(f"train step {k} albedo", a[2], b[2], atol=1e-5)
    (kd, kh, kept, kpeak), (pd, ph, _, ppeak) = runs["auto"], runs["plain"]
    phase(5, f"train step {W}x{H} (config 4, r1, 5 levels, exact): kernel "
             f"path {sum(kd) / len(kd):.3f} ms/step device, "
             f"{sum(kh) / len(kh):.3f} ms/step host wall over {len(kd)} "
             f"steps (min {min(kd):.3f}, max {max(kd):.3f}), peak memory "
             f"{kpeak / 2**30:.3f} GiB; plain path {sum(pd) / len(pd):.3f} "
             f"ms/step over {len(pd)}, peak {ppeak / 2**30:.3f} GiB; first "
             f"{CHECK_STEPS} steps match (loss {kept[0][0]:.6f}, "
             f"{kept[1][0]:.6f}); launches {counts}")
    return counts


def temporal_grad_phase(H, W, dev):
    """Differentiate the denoised frame with respect to motion and the
    history through ``svgf_denoise_frame(temporal="ad")``: K5 with the
    motion gradient, K6 without it."""
    P = random_planes(H, W, dev, seed=5)
    motion = (P["motion"] * (M / 7.0)).contiguous()   # |motion| <= M
    total = {k: 0 for k in WRAPPERS}
    grads = {}
    for impl in ("auto", "plain"):
        for motion_grad in (True, False):
            m = motion.clone().requires_grad_(motion_grad)
            hc = P["h_color"].clone().requires_grad_()
            g = GBuffer(render=P["color"],
                        albedo=torch.full_like(P["color"], 0.7),
                        normal=P["normal"], depth=P["depth"], motion=m)
            h = History(color=hc, moments=P["h_moments"],
                        length=P["h_length"], prev_depth=P["depth"],
                        prev_normal=P["normal"])
            if impl == "auto":
                reset_counts()
            out, _ = svgf_denoise_frame(g, h, params=TRAIN, impl=impl,
                                        temporal="ad",
                                        motion_grad=motion_grad)
            (out.denoised ** 2).mean().backward()
            if impl == "auto":
                counts = read_counts(6, ("K1", "K2", "K4") + (
                    ("K5",) if motion_grad else ("K6",)))
                for k, n in counts.items():
                    total[k] += n
            grads[impl, motion_grad] = (hc.grad, m.grad)
    for motion_grad in (True, False):
        (hk, mk), (hp, mp) = grads["auto", motion_grad], grads["plain",
                                                               motion_grad]
        check_close(f"d_history.color (motion_grad={motion_grad})", hk, hp,
                    atol=3e-3 * float(hp.abs().max()))
        if motion_grad:
            check_close("d_motion", mk, mp, atol=3e-3 * float(mp.abs().max()))
        elif mk is not None:
            raise AssertionError("motion gradient without motion_grad")
    phase(6, f"temporal gradient path {W}x{H}: d_motion and d_history match "
             f"the plain path; launches {total}")
    return total


def cli_phase():
    """The CLI's cases on the card, as ``python -m
    raymarchdenoisercuda_torch.cli -t`` runs them."""
    reset_counts()
    rc = cli.main(["-t", CLI_CASES])
    counts = read_counts(7, ("K10", "K12", "K1", "K3", "K7", "K8"))
    if rc != 0:
        raise AssertionError(f"phase 7: the CLI returned {rc}")
    phase(7, f"cli -t '{CLI_CASES}': all passed; launches {counts}")
    return counts


FILTER_TOLS = {FilterType.AVERAGE: dict(atol=1e-6, rtol=1e-5),
               FilterType.GAUSSIAN: dict(atol=1e-5),
               FilterType.CROSS: dict(atol=5e-5),
               FilterType.WAVELET: dict(atol=0.0, rtol=5e-5)}


def dataset_phase(H, W, dev):
    """generate_sequence at spp > 1, the dataset read back, the spp render
    against the plain path, and apply_filter on the loaded frame."""
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    # the device time of one frame's render (K7, 16 x K13), without the
    # host's PNG and npz writes
    scene = raymarch.cornell_scene(device=dev)
    cam = orbit_camera(0.0, device=dev)
    with torch.no_grad():
        raymarch.render_gbuffer(scene, cam, None, None, cam_cfg=cfg,
                                params=rm, spp=DATA_SPP)
        with CudaTimer() as tm:
            raymarch.render_gbuffer(scene, cam, None, None, cam_cfg=cfg,
                                    params=rm, spp=DATA_SPP)
    with tempfile.TemporaryDirectory() as root:
        reset_counts()
        t0 = time.perf_counter()
        frames = generate_sequence(root, "cornell_anim", DATA_FRAMES,
                                   cam_cfg=cfg, rm_params=rm, spp=DATA_SPP,
                                   seed=0, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        for f, g in enumerate(frames):
            fl = load_float_frame(root, "cornell_anim", f + 1, device=dev)
            for name in ("render", "albedo", "normal", "depth", "motion"):
                if not torch.equal(getattr(fl, name), getattr(g, name)):
                    raise AssertionError(f"frame {f}: planes.npz {name}")
            png = load_frame(root, "cornell_anim", f + 1, device=dev)
            for name in ("render", "albedo", "depth"):
                check_close(f"frame {f} {name}.png", getattr(png, name),
                            getattr(g, name).clamp(0.0, 1.0),
                            atol=1.0 / 255)
            # unit normals: 1/255 a component from the quantisation, and up
            # to sqrt(3)/255 more from the renormalisation after loading
            check_close(f"frame {f} normal.png", png.normal, g.normal,
                        atol=3.0 / 255, mask=g.depth > 0)

        # frame 0 against the plain path from the same seed
        want = raymarch.render_gbuffer(
            scene, cam, None, torch.Generator(dev).manual_seed(0),
            cam_cfg=cfg, params=rm, spp=DATA_SPP, impl="plain")
        got = frames[0]
        # the render within atol 1e-4 except where a hit, a material or one
        # sample's visibility flips on an ulp: at most 0.1 % of the frame
        flipped = ((got.albedo - want.albedo).abs().amax(0) > 1e-4) | (
            (got.depth - want.depth).abs() > 1e-4) | (
            (got.render - want.render).abs().amax(0) > 1e-4)
        if float(flipped.float().mean()) > 1e-3:
            raise AssertionError(f"phase 8: {int(flipped.sum())} pixels "
                                 f"flip against the plain render")
        keep = ~flipped
        for name in ("albedo", "depth", "motion"):
            check_close(f"frame 0 {name} (kernel vs plain)",
                        getattr(got, name), getattr(want, name), atol=1e-4,
                        mask=keep)
        check_close("frame 0 normal (kernel vs plain)", got.normal,
                    want.normal, atol=5e-4, rtol=5e-3, mask=keep)

        # the four filter types on the loaded frame, kernel vs plain
        g = load_frame(root, "cornell_anim", 1, device=dev)
        errs = {}
        for ftype in FilterType:
            p = FilterParams(type=ftype)
            a = filters.apply_filter(g, p).denoised
            b = filters.apply_filter(g, p, impl="plain").denoised
            check_close(f"apply_filter {ftype.name}", a, b,
                        **FILTER_TOLS[ftype])
            errs[ftype.name] = max_err(a, b)
    counts = read_counts(8, ("K7", "K11", "K13"))
    phase(8, f"generate_sequence {DATA_FRAMES} frames {W}x{H} spp "
             f"{DATA_SPP}: {gen_s:.3f} s host wall (PNG and npz writes "
             f"included; one frame's render alone {tm.ms:.3f} ms device); "
             f"read back exactly and to the PNG quantisation; "
             f"frame 0 matches the plain path ({int(flipped.sum())} flips); "
             f"apply_filter max |err| {errs}; launches {counts}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=SEQ_FRAMES)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's register/spill report")
    args = ap.parse_args(argv)
    W, H = args.width, args.height

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi_name_power()
    phase(1, f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=args.verbose_build)
    _build.kernels()
    phase(2, f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    results = {}
    P = random_planes(H, W, dev, seed=0)
    check_k1(P, results)
    check_k1_store_k2(P, results)
    check_k3(P, results)
    check_k4_k5_k6(P, results)
    check_filters(P, results)
    check_k7_k8(H, W, dev, results)
    check_k13(H, W, dev, results)
    del P
    torch.cuda.synchronize()

    launches = {k: 0 for k in WRAPPERS}
    for run in (lambda: serving_phase(H, W, dev, args.frames),
                lambda: train_phase(H, W, dev),
                lambda: temporal_grad_phase(H, W, dev), cli_phase,
                lambda: dataset_phase(H, W, dev)):
        for k, n in run().items():
            launches[k] += n

    report = []
    for k, (name, source, replaces) in KERNELS.items():
        r = results[k]
        bound_ms, bound_by = bound(r.pop("bytes"), r.pop("flops"))
        report.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[k],
                           max_abs_err=r["max_abs_err"], ms=r["ms"],
                           plain_ms=r["plain_ms"], bound_ms=bound_ms,
                           bound_by=bound_by,
                           library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
