"""Denoiser quality against a converged render: the reference's product
claim (denoise 1-spp renders), measured.

Counterpart of ``tools/denoise_quality.py``.  :func:`render_sequence`
renders a camera orbit twice, noisy at 1 light sample a pixel and
converged at ``spp_ref`` (``render_gbuffer(spp=...)``: on the card K7,
then K13 once a sample); :func:`score` runs ``svgf_denoise_frame`` (the
temporal step and the spatial sweep) over the noisy frames and reports the
PSNR and SSIM of input and output against the converged render, averaged
over the frames from ``warmup`` on; :func:`run_eval` does both.  One
rendered sequence serves every filter setting of a scene.

Only the frames from ``warmup`` on have a reference.  The noisy frames and
the references draw their light samples from two generators, so rendering
fewer references leaves the noisy stream as it is.  torch's generator is
not threefry: the metrics are the JAX tool's in kind, not its numbers to
the digit; the gate holds the thresholds of ``tests/test_quality.py``
(``tests/test_torch_quality.py``).

    python -m raymarchdenoisercuda_torch.utils.denoise_quality \\
        [--size 256 --frames 16 --spp-ref 1024 --iters 5 --radius 2
         --luma-from N --wmath exact|fast --impl cuda|cpu
         --scene cornell|clutter --clutter-seed 5]

prints one JSON line.  ``--impl`` picks the device (default the card;
``cpu`` runs the plain PyTorch versions, the JAX tool's ``reference``);
``--pyramid-from`` is not ported (it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..device import resolve_device
from ..gbuffer import GBuffer, History
from ..io.generate import orbit_camera
from ..models.svgf import svgf_denoise_frame
from ..ops.raymarch import cornell_scene, random_scene, render_gbuffer


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-12))


def ssim(a, b, peak=1.0, win=7):
    """Mean SSIM over channels with a uniform win x win window (display-
    referred inputs in [0, peak]), over the window's valid region."""
    from numpy.lib.stride_tricks import sliding_window_view

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2

    def filt(x):
        return sliding_window_view(x, (win, win), axis=(-2, -1)).mean(
            axis=(-2, -1))

    vals = []
    for c in range(a.shape[0]):
        mu_a, mu_b = filt(a[c]), filt(b[c])
        va = filt(a[c] * a[c]) - mu_a ** 2
        vb = filt(b[c] * b[c]) - mu_b ** 2
        cov = filt(a[c] * b[c]) - mu_a * mu_b
        s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
            (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


@dataclasses.dataclass
class Sequence:
    """A rendered orbit: the noisy G-buffers of every frame and, for each
    frame from ``warmup`` on, the converged render clipped to [0, 1]
    (numpy, (3, H, W))."""

    frames: List[GBuffer]
    refs: Dict[int, np.ndarray]
    warmup: int
    label: str


def make_scene(scene_kind: str = "cornell", clutter_seed: int = 5, *,
               device=None):
    """The gate's scenes: the Cornell box, or ``clutter``, the procedural
    scene of 14 spheres, 14 boxes and 12 materials."""
    if scene_kind == "cornell":
        return cornell_scene(device=device)
    if scene_kind == "clutter":
        return random_scene(n_spheres=14, n_boxes=14, n_materials=12,
                            seed=clutter_seed, device=device)
    raise ValueError(f"unknown scene: {scene_kind!r}")


def render_sequence(size: int = 256, frames: int = 16, spp_ref: int = 1024,
                    warmup: int = 4, scene_kind: str = "cornell",
                    clutter_seed: int = 5, *, device=None,
                    seed: int = 0) -> Sequence:
    """The noisy (1 spp) frames of an orbit of ``frames`` poses at
    ``size``² and the ``spp_ref``-sample renders of the frames from
    ``warmup`` on, the two from generators seeded ``seed`` and ``seed +
    1``."""
    device = resolve_device(device)
    scene = make_scene(scene_kind, clutter_seed, device=device)
    cfg = CameraParams(width=size, height=size)
    rm = RaymarchParams()
    noisy_gen = torch.Generator(device).manual_seed(seed)
    ref_gen = torch.Generator(device).manual_seed(seed + 1)
    out, refs, prev = [], {}, None
    with torch.no_grad():
        for f in range(frames):
            cam = orbit_camera(f / frames, device=device)
            out.append(render_gbuffer(scene, cam, prev, noisy_gen,
                                      cam_cfg=cfg, params=rm, spp=1))
            if f >= warmup:
                ref = render_gbuffer(scene, cam, None, ref_gen, cam_cfg=cfg,
                                     params=rm, spp=spp_ref)
                refs[f] = np.clip(ref.render.cpu().numpy(), 0, 1)
            prev = cam
    return Sequence(out, refs, warmup,
                    f"{spp_ref}-spp converged render, {frames}-frame orbit "
                    f"{size}^2 ({device.type}, {scene_kind})")


def _no_pyramid(pyramid_from):
    if pyramid_from is not None:
        raise NotImplementedError(
            "pyramid_from is not ported: it failed the two-scene quality "
            "gate in the JAX package")


def score(seq: Sequence, iterations: int = 5, radius: int = 2,
          weight_math: str = "exact", luma_only_from: Optional[int] = None,
          pyramid_from: Optional[int] = None) -> Dict:
    """``svgf_denoise_frame`` over the sequence's noisy frames from an empty
    history; the mean PSNR and SSIM of input and output against the
    references (the JAX tool's keys and rounding)."""
    _no_pyramid(pyramid_from)
    sv = SVGFParams(iterations=iterations, radius=radius,
                    luma_only_from=luma_only_from)
    H, W = seq.frames[0].depth.shape
    hist = History.zeros(H, W, device=seq.frames[0].depth.device)
    m = {k: [] for k in ("in_psnr", "out_psnr", "in_ssim", "out_ssim")}
    with torch.no_grad():
        for f, g in enumerate(seq.frames):
            out, hist = svgf_denoise_frame(g, hist, params=sv,
                                           weight_math=weight_math)
            if f < seq.warmup:
                continue
            tgt = seq.refs[f]
            noisy = np.clip(g.render.cpu().numpy(), 0, 1)
            den = np.clip(out.denoised.cpu().numpy(), 0, 1)
            m["in_psnr"].append(psnr(noisy, tgt))
            m["out_psnr"].append(psnr(den, tgt))
            m["in_ssim"].append(ssim(noisy, tgt))
            m["out_ssim"].append(ssim(den, tgt))
    mean = {k: float(np.mean(v)) for k, v in m.items()}
    return {
        "metric": f"denoiser quality vs {seq.label}, r{radius} "
                  f"{iterations} iterations, {weight_math} weights"
                  + (f", luma-only from {luma_only_from}"
                     if luma_only_from is not None else ""),
        "input_psnr_db": round(mean["in_psnr"], 2),
        "output_psnr_db": round(mean["out_psnr"], 2),
        "psnr_gain_db": round(mean["out_psnr"] - mean["in_psnr"], 2),
        "input_ssim": round(mean["in_ssim"], 4),
        "output_ssim": round(mean["out_ssim"], 4),
    }


def run_eval(size=256, frames=16, spp_ref=1024, warmup=4, impl=None,
             iterations=5, radius=2, weight_math="exact",
             luma_only_from=None, scene_kind="cornell", pyramid_from=None,
             clutter_seed=5) -> Dict:
    """:func:`render_sequence`, then :func:`score`; ``impl`` is the device
    ("cuda", "cpu"; None: the card; the JAX tool's "reference" is the
    CPU's plain path)."""
    _no_pyramid(pyramid_from)
    device = "cpu" if impl == "reference" else impl
    seq = render_sequence(size, frames, spp_ref, warmup, scene_kind,
                          clutter_seed, device=device)
    return score(seq, iterations, radius, weight_math, luma_only_from)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--spp-ref", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--luma-from", type=int, default=None)
    ap.add_argument("--wmath", default="exact", choices=["exact", "fast"])
    ap.add_argument("--impl", default=None,
                    choices=[None, "cuda", "cpu", "reference"],
                    help="the device (default: the card); reference = cpu")
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "clutter"])
    ap.add_argument("--pyramid-from", type=int, default=None,
                    help="not ported: raises")
    ap.add_argument("--clutter-seed", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run_eval(
        size=args.size, frames=args.frames, spp_ref=args.spp_ref,
        warmup=args.warmup, impl=args.impl, iterations=args.iters,
        radius=args.radius, weight_math=args.wmath,
        luma_only_from=args.luma_from, scene_kind=args.scene,
        pyramid_from=args.pyramid_from, clutter_seed=args.clutter_seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
