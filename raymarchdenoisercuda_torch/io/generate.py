"""Dataset generation: camera paths, and animated G-buffer sequences
rendered to disk.

Counterpart of ``raymarchdenoisercuda_tpu/io/generate.py``: the port's
raymarcher renders ``<root>/<scene>/<frame>/{render,albedo,normal,depth}.png``
(the reference's layout) plus ``planes.npz`` of the float planes (motion
vectors and exact depth do not survive 8-bit PNGs).  ``spp`` light samples
average into the render plane: at ``spp > 1`` the shadow rays go through
K13 on the card.

    python -m raymarchdenoisercuda_torch.io.generate out_dir --frames 8 --spp 16

runs on the CUDA card; ``generate_sequence(..., device="cpu")`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import CameraParams, RaymarchParams
from ..device import resolve_device
from ..gbuffer import GBuffer
from ..ops.raymarch import (Camera, Scene, cornell_camera, cornell_scene,
                            make_camera, render_gbuffer)
from .dataset import frame_dir, save_frame


def orbit_camera(t: float, radius: float = 1.7, *, device=None) -> Camera:
    """Camera slowly orbiting and bobbing in front of the Cornell box, on
    ``device`` (default: the CUDA card).

    ``t`` in [0, 1) over the sequence; the motion is small enough that most
    pixels reproject.  Numpy math rounded to float32 as the reference rounds
    it, so both packages see the same poses."""
    ang = 0.25 * np.sin(2 * np.pi * t)
    x = radius * np.sin(ang) * 0.4
    y = 0.08 * np.sin(4 * np.pi * t)
    z = -radius + 0.12 * np.cos(2 * np.pi * t) - 0.12
    return make_camera([x, y, z], device=device)


def generate_sequence(
    root: str,
    scene_name: str = "cornell_anim",
    frames: int = 8,
    *,
    scene: Optional[Scene] = None,
    cam_cfg: CameraParams = CameraParams(width=512, height=512),
    rm_params: RaymarchParams = RaymarchParams(),
    spp: int = 1,
    seed: int = 0,
    animate: bool = True,
    save_float: bool = True,
    device=None,
) -> List[GBuffer]:
    """Render ``frames`` G-buffers on ``device`` (default: the CUDA card;
    the scene's device when ``scene`` is given), write them in the dataset
    layout and return them.

    The light samples come from one ``torch.Generator`` seeded with
    ``seed``, frame after frame (``jax.random`` draws other numbers, so
    the render plane differs from the JAX package's by its noise; the
    other planes agree).  ``save_float`` also writes each frame's float32
    planes, motion included, to ``planes.npz``."""
    device = scene.device if scene is not None else resolve_device(device)
    scene = scene if scene is not None else cornell_scene(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    prev_cam = None
    out = []
    with torch.no_grad():
        for f in range(frames):
            cam = (orbit_camera(f / max(frames, 1), device=device) if animate
                   else cornell_camera(device=device))
            g = render_gbuffer(scene, cam, prev_cam, gen, cam_cfg=cam_cfg,
                               params=rm_params, spp=spp)
            save_frame(root, scene_name, f + 1, g)
            if save_float:
                np.savez(os.path.join(frame_dir(root, scene_name, f + 1),
                                      "planes.npz"),
                         **{k: getattr(g, k).cpu().numpy() for k in (
                             "render", "albedo", "normal", "depth",
                             "motion")})
            out.append(g)
            prev_cam = cam
    return out


def load_float_frame(root: str, scene_name: str, frame: int, *,
                     device=None) -> GBuffer:
    """The float planes :func:`generate_sequence` wrote for ``frame``, on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    d = np.load(os.path.join(frame_dir(root, scene_name, frame), "planes.npz"))

    def t(k):
        return torch.from_numpy(d[k]).to(device)

    return GBuffer(render=t("render"), albedo=t("albedo"), normal=t("normal"),
                   depth=t("depth"), motion=t("motion"), denoised=None)


def main(argv=None, *, device=None) -> int:
    """Command line of :func:`generate_sequence` (the JAX package's options;
    ``device`` is for callers that run it on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--scene", default="cornell_anim")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--static", action="store_true", help="fixed camera")
    args = ap.parse_args(argv)
    generate_sequence(
        args.out_dir, args.scene, args.frames,
        cam_cfg=CameraParams(width=args.size, height=args.size),
        spp=args.spp, animate=not args.static, device=device)
    print(f"wrote {args.frames} frames to {args.out_dir}/{args.scene}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
