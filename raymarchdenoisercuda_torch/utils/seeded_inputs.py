"""Seeded inputs of the temporal kernels, as ``chip_smoke.py`` phase 3,
``utils/kernel_ab.py`` and ``utils/profile.py clamped`` give them: the
served frame's (the Cornell box through ``FramePipeline`` for the orbit
frames before the ninth) and the clamped gather's (KG, KGb) on random
motion and on the served frame.  Each takes the frame's sides and the
device; the same arguments give the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SERVED_FRAME = 8                     # the served frame: its orbit index
ORBIT_FRAMES = 16                    # frames a turn of phase 4's orbit


def served_inputs(H, W, dev, unbounded=False):
    """``(gbuf, history)``: the served frame's temporal inputs, the Cornell
    box at H x W through this tree's ``FramePipeline`` (``chip_smoke.py``
    phase 4's settings; ``unbounded``: phase 11(c)'s, ``max_motion=None``)
    for the orbit frames before ``SERVED_FRAME``."""
    from ..config import CameraParams, RaymarchParams, SVGFParams
    from ..gbuffer import History
    from ..io.generate import orbit_camera
    from ..models.pipeline import FramePipeline
    from ..ops import raymarch
    svgf = (SVGFParams(radius=1, max_motion=None) if unbounded
            else SVGFParams(radius=1))
    pipe = FramePipeline(raymarch.cornell_scene(device=dev),
                         cam_cfg=CameraParams(width=W, height=H),
                         rm_params=RaymarchParams(), svgf_params=svgf,
                         weight_math="fast")
    gen = torch.Generator(dev).manual_seed(0)
    hist, prev = History.zeros(H, W, device=dev), None
    for f in range(SERVED_FRAME + 1):
        cam = orbit_camera(f / ORBIT_FRAMES, device=dev)
        if f == SERVED_FRAME:
            return pipe.renderer(cam, prev, gen), hist
        _, hist = pipe(cam, prev, hist, gen)
        prev = cam


def _cotangent(rng, H, W, dev):
    """A seeded cotangent of the clamped gather's 10 planes, zero beyond the
    6 that have a gradient."""
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    g[6:] = 0.0
    return g


def clamped_inputs(H, W, dev, scale=56.0):
    """``(stack, motion, g)``: ``chip_smoke.py`` phase 3's input of the
    clamped gather (KG) and its adjoint (KGb), a seeded planar (10, H, W)
    stack, uniform random motion to ±``scale``/2 pixels and a
    cotangent."""
    rng = np.random.default_rng(13)
    stack = torch.from_numpy(rng.random((10, H, W),
                                        dtype=np.float32)).to(dev)
    motion = torch.from_numpy(((rng.random((2, H, W)) - 0.5)
                               * scale).astype(np.float32)).to(dev)
    return stack, motion, _cotangent(rng, H, W, dev)


def served_clamped_inputs(H, W, dev):
    """``(stack, motion, g)``: KG's and KGb's inputs on the served frame,
    the planar history stack and the motion of the ninth orbit frame
    through this tree's pipeline with ``max_motion=None`` (phase 11(c)),
    and a seeded cotangent."""
    from ..ops.temporal import history_stack
    gbuf, hist = served_inputs(H, W, dev, unbounded=True)
    return (history_stack(hist), gbuf.motion,
            _cotangent(np.random.default_rng(14), H, W, dev))
