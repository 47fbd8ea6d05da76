#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (each prints one line; any failure raises and the script exits
non-zero without printing a result):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``raymarchdenoisercuda_torch/ops/cuda/*.cu``;
3. hold each kernel (K1 à-trous level, K3 temporal step, K7 march, K8
   shadow + shading) against its plain PyTorch version on the card at the
   1080p shapes of the serving path, and time both with CUDA events;
4. run the slice: 16 frames of the animated Cornell sequence at 1920x1080
   (``orbit_camera``) through ``FramePipeline`` (render -> temporal ->
   5-level à-trous, radius 1, fast weights), with every kernel's launch
   count reset just before and read just after; check the frames are finite
   and that the kernel path matches the plain path for the first 3 frames.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import FramePipeline
from raymarchdenoisercuda_torch.ops import atrous, raymarch, temporal
from raymarchdenoisercuda_torch.ops.atrous_cuda import svgf_spatial_cuda
from raymarchdenoisercuda_torch.ops.cuda import _build
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    march_gbuf_cuda, shadow_shade_cuda)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    temporal_accumulate_cuda)
from raymarchdenoisercuda_torch.utils.timing import (
    CudaTimer, cuda_time_ms, nvidia_smi_name_power)

SEQ_FRAMES = 16
CHECK_FRAMES = 3
SERVING = SVGFParams(radius=1)       # the adopted mode: radius 1 ...
SERVING_WEIGHTS = "fast"             # ... with fast tap weights
WRAPPERS = {"K1": svgf_spatial_cuda, "K3": temporal_accumulate_cuda,
            "K7": march_gbuf_cuda, "K8": shadow_shade_cuda}
KERNELS = {
    "K1": ("atrous_level", "raymarchdenoisercuda_torch/ops/cuda/atrous.cu",
           "raymarchdenoisercuda_tpu/ops/pallas/atrous_tpu.py:172"),
    "K3": ("temporal_step", "raymarchdenoisercuda_torch/ops/cuda/temporal.cu",
           "raymarchdenoisercuda_tpu/ops/pallas/temporal_tpu.py:57"),
    "K7": ("march_gbuf", "raymarchdenoisercuda_torch/ops/cuda/raymarch.cu",
           "raymarchdenoisercuda_tpu/ops/pallas/raymarch_tpu.py:115"),
    "K8": ("shadow_shade", "raymarchdenoisercuda_torch/ops/cuda/raymarch.cu",
           "raymarchdenoisercuda_tpu/ops/pallas/raymarch_tpu.py:468"),
}


def phase(n, msg):
    print(f"phase {n}: {msg}", flush=True)


def max_err(a, b, mask=None):
    d = (a - b).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, got, want, *, atol, rtol=0.0, mask=None):
    """Raise unless |got - want| <= atol + rtol·|want| (where ``mask``)."""
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol={atol:.3g} rtol={rtol:.3g} (max |diff| "
            f"{float((got - want).abs().max()):.3g})")


def random_planes(H, W, dev, seed):
    """Seeded SVGF inputs of the serving path's shapes."""
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
                results["K1"] = dict(max_abs_err=err, ms=ms / SERVING.iterations,
                                     plain_ms=plain_ms / SERVING.iterations)


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
    results["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    phase(3, f"K3: ok, max |err| {err:.3g}, {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms")


def check_k7_k8(H, W, dev, results):
    scene = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)

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
    results["K7"] = dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms)
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
    results["K8"] = dict(max_abs_err=err8, ms=ms, plain_ms=plain_ms)
    phase(3, f"K8: ok, {int((~same).sum())} flips, max |err| {err8:.3g}, "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms")


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
    check_k3(P, results)
    check_k7_k8(H, W, dev, results)
    del P
    torch.cuda.synchronize()

    scene = raymarch.cornell_scene(device=dev)
    pipe_cfg = dict(cam_cfg=CameraParams(width=W, height=H),
                    rm_params=RaymarchParams(), svgf_params=SERVING,
                    weight_math=SERVING_WEIGHTS)
    kernel_pipe = FramePipeline(scene, impl="auto", **pipe_cfg)
    plain_pipe = FramePipeline(scene, impl="plain", **pipe_cfg)
    keep = min(CHECK_FRAMES, args.frames)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    times, kernel_frames = run_sequence(kernel_pipe, args.frames, H, W, dev,
                                        keep)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    plain_times, plain_frames = run_sequence(plain_pipe, keep, H, W, dev,
                                             keep)
    for f, (a, b) in enumerate(zip(kernel_frames, plain_frames)):
        check_close(f"frame {f} denoised (kernel vs plain)", a, b,
                    atol=1e-3 * float(b.abs().max()))
    steady = times[1:] or times
    phase(4, f"{args.frames} frames {W}x{H}: kernel path "
             f"{sum(times) / len(times):.3f} ms/frame (frames 2-{args.frames}:"
             f" {sum(steady) / len(steady):.3f}), plain path "
             f"{sum(plain_times) / len(plain_times):.3f} ms/frame over "
             f"{keep}; first {keep} frames match; launches {launches}")

    report = []
    for k, (name, source, replaces) in KERNELS.items():
        report.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[k],
                           **results[k]))
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
