"""Command-line entry point: ``python -m raymarchdenoisercuda_torch.cli``.

Counterpart of ``raymarchdenoisercuda_tpu/cli.py`` and the reference CLI
(``src/main.cpp``): ``-t [regex]`` runs the registered cases (all by
default), ``-h`` prints the usage, an unknown option goes to stderr.  The
cases are the JAX CLI's, at its 1920x1080 (the reference's test buffers),
each printing its milliseconds like the reference runner and Mpix/s where
meaningful.  They run on the CUDA card, through the kernels; ``main(argv,
device="cpu")`` runs them on the CPU through the plain versions.

Cases: FILTER_BASELINE (the plain ``box_filter``), FILTER_TILED (K10),
SVGF_SPATIAL (the K1 sweep), RAYMARCH (K7, K8 at 512x512), TEMPORAL (K3),
FILTER_CROSS (K12), DEVICE_STATS, IMAGE and DENOISE_CORNELL.  The last two
read the reference checkout's Cornell fixture from the directory named by
the ``RDT_REFERENCE_ROOT`` environment variable and fail without it.
SHARDED_SPATIAL is not registered: the multi-device path is not ported.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from . import testing
from .device import resolve_device
from .testing import case_

H, W = 1080, 1920   # the reference's test buffers are full HD


def _fixture_root() -> str:
    root = os.environ.get("RDT_REFERENCE_ROOT")
    if not root:
        raise RuntimeError("missing fixture: set RDT_REFERENCE_ROOT to the "
                           "reference checkout")
    return os.path.join(root, "render")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _register_builtin_cases(device: torch.device):
    from .config import CameraParams, FilterParams, FilterType, SVGFParams
    from .utils.timing import mpix_per_s, print_device_properties, time_fn

    on_card = device.type == "cuda"
    kind = "kernel" if on_card else "plain"

    def timed(fn, repeats):
        with torch.no_grad():
            return time_fn(fn, repeats=repeats, device=device)

    def rand_planes(h, w):
        rng = np.random.default_rng(0)
        color = rng.random((3, h, w), dtype=np.float32)
        variance = (0.02 * rng.random((h, w))).astype(np.float32)
        n = rng.standard_normal((3, h, w)).astype(np.float32)
        n[2] += 3.0
        n /= np.sqrt((n ** 2).sum(0, keepdims=True))
        depth = (0.3 + 0.5 * rng.random((h, w))).astype(np.float32)
        return tuple(torch.from_numpy(a).to(device)
                     for a in (color, variance, n, depth))

    @case_("FILTER_BASELINE")
    def filter_baseline():
        # the reference's 1920x1080, radius 2, depth 1 average filter
        from .ops.boxfilter import box_filter
        x = rand_planes(H, W)[0]
        dt, _ = timed(lambda: box_filter(x, radius=2, depth=1), 5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s (plain PyTorch)")

    @case_("FILTER_TILED")
    def filter_tiled():
        # the reference's tiled-kernel configuration; K10 on the card
        from .ops.filters_cuda import box_filter_cuda
        x = rand_planes(H, W)[0]
        dt, _ = timed(lambda: box_filter_cuda(x, radius=2, depth=1), 5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s ({kind})")

    @case_("SVGF_SPATIAL")
    def svgf_spatial():
        from .ops.atrous_cuda import svgf_spatial_cuda
        color, variance, normal, depth = rand_planes(H, W)
        params = SVGFParams(iterations=5)
        dt, _ = timed(lambda: svgf_spatial_cuda(color, variance, normal,
                                                depth, params=params), 5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s fwd ({kind})")

    @case_("RAYMARCH")
    def raymarch_case():
        from .ops.raymarch import cornell_camera, cornell_scene, render_gbuffer
        cfg = CameraParams(width=512, height=512)
        scene = cornell_scene(device=device)
        cam = cornell_camera(device=device)
        gen = torch.Generator(device).manual_seed(0)
        dt, _ = timed(lambda: render_gbuffer(scene, cam, cam, gen,
                                             cam_cfg=cfg), 3)
        print(f"\t{mpix_per_s(512, 512, dt):.1f} Mpix/s ({kind})")

    @case_("TEMPORAL")
    def temporal_case():
        from .gbuffer import GBuffer, History
        from .ops.temporal_cuda import temporal_accumulate_cuda
        color, _v, normal, depth = rand_planes(H, W)
        motion = torch.empty((2, H, W), device=device)
        motion[0], motion[1] = 1.3, -2.7
        g = GBuffer(render=color, albedo=torch.full_like(color, 0.7),
                    normal=normal, depth=depth, motion=motion)
        hist = History.zeros(H, W, device=device)
        params = SVGFParams()
        dt, (integ, _var, _h) = timed(
            lambda: temporal_accumulate_cuda(g, hist, params=params), 5)
        _check(bool(torch.isfinite(integ).all()), "non-finite output")
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s ({kind})")

    @case_("FILTER_CROSS")
    def filter_cross():
        from .ops.filters_cuda import cross_bilateral_cuda
        color, _v, normal, depth = rand_planes(H, W)
        albedo = torch.full_like(color, 0.7)
        p = FilterParams(type=FilterType.CROSS)
        dt, out = timed(lambda: cross_bilateral_cuda(color, albedo, normal,
                                                     depth, params=p), 5)
        _check(bool(torch.isfinite(out).all()), "non-finite output")
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s ({kind})")

    @case_("DEVICE_STATS")
    def device_stats():
        # the reference skips this case; it runs here
        print_device_properties(device)

    @case_("IMAGE")
    def image_roundtrip():
        # a PNG round trip of the reference's Cornell render
        from .io import load_png, save_png
        src = os.path.join(_fixture_root(), "cornell", "1", "render.png")
        if not os.path.exists(src):
            raise RuntimeError(f"missing fixture {src}")
        img = load_png(src)
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "roundtrip.png")
            save_png(out, img)
            back = load_png(out)
        _check(np.array_equal(img, back), "png roundtrip mismatch")

    @case_("DENOISE_CORNELL")
    def denoise_cornell():
        from .gbuffer import History
        from .io import load_frame, save_frame
        from .models.svgf import svgf_denoise_frame
        root = _fixture_root()
        if not os.path.isdir(os.path.join(root, "cornell", "1")):
            raise RuntimeError("Cornell dataset not found")
        g = load_frame(root, "cornell", 1, device=device)
        with torch.no_grad():
            out, _ = svgf_denoise_frame(
                g, History.zeros(*g.shape, device=device),
                params=SVGFParams(iterations=5))
        _check(bool(torch.isfinite(out.denoised).all()), "non-finite output")
        dest = os.path.join(tempfile.gettempdir(), "rdt_out")
        save_frame(dest, "cornell", 1, out)
        print(f"\twrote {dest}/cornell/1/denoised.png")


def print_help(prog: str):
    print(f"Usage: {prog} [options]\n"
          "Options:\n"
          "  -t [label]   Run all tests, or those matching the regex label\n"
          "  -h           Show this help message")


def main(argv=None, *, device=None) -> int:
    """Run the CLI; the cases run on ``device`` (default: the CUDA card,
    and an error where there is none)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "raymarchdenoisercuda_torch.cli"
    if not argv or argv[0] == "-h":
        print_help(prog)
        return 0
    if argv[0] == "-t":
        _register_builtin_cases(resolve_device(device))
        wildcard = argv[1] if len(argv) > 1 else ".*"
        return 0 if testing.run(wildcard) else 1
    print(f"Unknown option: {argv[0]}", file=sys.stderr)
    print_help(prog)
    return 2


if __name__ == "__main__":
    sys.exit(main())
