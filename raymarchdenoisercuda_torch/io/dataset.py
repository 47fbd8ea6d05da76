"""Dataset reader and writer for the ``<root>/<scene>/<frame>/<plane>.png``
layout.

Counterpart of ``raymarchdenoisercuda_tpu/io/dataset.py``: the four
G-buffer planes of a frame (render, albedo, normal, depth PNGs, the layout
of the reference's Cornell fixture) as a :class:`GBuffer` of planar float32
tensors on a device, and back.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..gbuffer import GBuffer
from .image import ImageIOError, load_plane, save_plane

PLANES = ("render", "albedo", "normal", "depth")


def frame_dir(root: str, scene: str, frame) -> str:
    return os.path.join(root, scene, str(frame))


def list_frames(root: str, scene: str) -> List[int]:
    """Sorted numeric frame ids of a scene."""
    d = os.path.join(root, scene)
    if not os.path.isdir(d):
        raise ImageIOError(f"no such scene directory: {d}")
    return sorted(int(name) for name in os.listdir(d)
                  if re.fullmatch(r"\d+", name)
                  and os.path.isdir(os.path.join(d, name)))


def load_frame(root: str, scene: str, frame, *, device=None) -> GBuffer:
    """One frame's G-buffer planes on ``device`` (default: the CUDA card).

    Normal PNGs hold unit vectors mapped to [0, 1]; they are mapped back to
    [-1, 1] and renormalised.  Depth PNGs are one channel in [0, 1]."""
    device = resolve_device(device)
    d = frame_dir(root, scene, frame)
    render = load_plane(os.path.join(d, "render.png"), channels=3)
    albedo = load_plane(os.path.join(d, "albedo.png"), channels=3)
    normal = load_plane(os.path.join(d, "normal.png"), channels=3) * 2.0 - 1.0
    depth = load_plane(os.path.join(d, "depth.png"), channels=1)[0]
    norm = np.sqrt(np.sum(normal * normal, axis=0, keepdims=True))
    normal = normal / np.maximum(norm, 1e-6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return GBuffer(render=t(render), albedo=t(albedo), normal=t(normal),
                   depth=t(depth), motion=None, denoised=None)


def iter_sequence(root: str, scene: str, frames: Optional[List[int]] = None,
                  *, device=None) -> Iterator[GBuffer]:
    """The frames of a sequence in order (all of them by default)."""
    for f in frames if frames is not None else list_frames(root, scene):
        yield load_frame(root, scene, f, device=device)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_frame(root: str, scene: str, frame, gbuf: GBuffer) -> None:
    """Write a G-buffer's planes (``denoised`` too, when set) in the
    dataset layout."""
    d = frame_dir(root, scene, frame)
    os.makedirs(d, exist_ok=True)
    save_plane(os.path.join(d, "render.png"), _np(gbuf.render))
    save_plane(os.path.join(d, "albedo.png"), _np(gbuf.albedo))
    save_plane(os.path.join(d, "normal.png"), _np(gbuf.normal) * 0.5 + 0.5)
    save_plane(os.path.join(d, "depth.png"), _np(gbuf.depth)[None])
    if gbuf.denoised is not None:
        save_plane(os.path.join(d, "denoised.png"), _np(gbuf.denoised))
