"""Seeded inputs of the temporal kernels, as ``chip_smoke.py`` phase 3,
``utils/kernel_ab.py`` and ``utils/profile.py clamped`` give them: the
served frame's (the Cornell box through ``FramePipeline`` for the orbit
frames before the ninth), the bounded gather's (K4-K6) and the clamped
gather's (KG, KGb), each on random motion and on the served frame, and
the sink motion of K5/K6's wide forms.  Each takes the frame's sides and
the device; the same arguments give the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SERVED_FRAME = 8                     # the served frame: its orbit index
ORBIT_FRAMES = 16                    # frames a turn of phase 4's orbit


def served_inputs(H, W, dev, unbounded=False, frame=SERVED_FRAME,
                  orbit_frames=ORBIT_FRAMES):
    """``(gbuf, history)``: the served frame's temporal inputs, the Cornell
    box at H x W through this tree's ``FramePipeline`` (``chip_smoke.py``
    phase 4's settings; ``unbounded``: phase 11(c)'s, ``max_motion=None``)
    for the orbit frames before ``frame``, ``orbit_frames`` a turn."""
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
    for f in range(frame + 1):
        cam = orbit_camera(f / orbit_frames, device=dev)
        if f == frame:
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


def gather_inputs(H, W, dev, kind="random", max_motion=6):
    """``(stack, motion, g)``: the bounded gather's (K4) and its adjoints'
    (K5/K6) inputs, a seeded planar (10, H, W) history stack, motion and a
    cotangent of the 10 planes.  ``kind``: "random", uniform random motion
    to ±(max_motion + 1) pixels (``chip_smoke.py`` phase 3's kind: some
    pixels beyond max_motion); "integer", the same rounded; "zero";
    "served", the served frame's history stack and motion (the camera's,
    coherent) in place of the seeded ones."""
    rng = np.random.default_rng(15)
    stack = torch.from_numpy(rng.random((10, H, W),
                                        dtype=np.float32)).to(dev)
    m = (rng.random((2, H, W)) - 0.5) * 2 * (max_motion + 1)
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    if kind == "served":
        from ..ops.temporal import history_stack
        gbuf, hist = served_inputs(H, W, dev)
        return history_stack(hist), gbuf.motion, g
    m = {"random": m, "integer": np.round(m),
         "zero": np.zeros_like(m)}[kind]
    return stack, torch.from_numpy(m.astype(np.float32)).to(dev), g


def sink_motion(motion, max_motion):
    """``motion`` with a sink: every source p of the (2M + 1)^2 window
    around the frame's middle c moved by clip(c - p + 0.25, -M, M), so
    that all of them are accepted and anchored at c (their 2 x 2 taps' top
    left): the longest segment K5/K6's scatter route can be given.  The
    other pixels keep their motion."""
    H, W = motion.shape[-2:]
    cy, cx = H // 2, W // 2
    M = max_motion
    iy = torch.arange(H, device=motion.device, dtype=torch.float32)[:, None]
    ix = torch.arange(W, device=motion.device, dtype=torch.float32)[None, :]
    to_y = (cy - iy + 0.25).clamp(-M, M).expand(H, W)
    to_x = (cx - ix + 0.25).clamp(-M, M).expand(H, W)
    window = ((iy - cy).abs() <= M) & ((ix - cx).abs() <= M)
    return torch.where(window[None], torch.stack([to_y, to_x]), motion)


def sink_texels(H, W, origin=(0, 0)):
    """The four texels a :func:`sink_motion` of an H x W frame (its middle)
    fills, ``(qy, qx)`` relative to the tile at ``origin``: the anchor and
    its right, lower and lower right neighbours."""
    cy, cx = H // 2 - origin[0], W // 2 - origin[1]
    return [(cy + a, cx + b) for a in (0, 1) for b in (0, 1)]


def ordered_texel_sums(motion, g, max_motion, texels):
    """``(len(texels), 6)`` float32: the history gradient of K5/K6 with 6
    gradient planes (the wide forms' checks) at
    the texels ``(qy, qx)`` (coordinates of the tile whose motion and
    cotangent are given), each the sum over the sources p whose 2 x 2 taps
    reach it, in descending source index, of tent(m0 - oy) * tent(m1 - ox)
    * g[c][p] (o = q - p), every product and sum rounded to float32 as the
    kernels round them.  A sink's texels sum tens of thousands of addends,
    where the twin's ``index_add_`` order gives other floats: they are held
    to these bit for bit."""
    m = motion.detach().cpu().numpy()
    gg = g.detach().cpu().numpy().reshape(g.shape[0], -1)
    H, W = m.shape[1:]
    f32 = np.float32
    m0, m1 = m[0].ravel(), m[1].ravel()
    py, px = np.divmod(np.arange(H * W), W)
    ok = (np.abs(m0) <= max_motion) & (np.abs(m1) <= max_motion)
    ay = py + np.floor(m0).astype(np.int64)
    ax = px + np.floor(m1).astype(np.int64)
    planes = 6
    out = np.zeros((len(texels), planes), f32)
    for i, (qy, qx) in enumerate(texels):
        p = np.flatnonzero(ok & ((qy - ay) >= 0) & ((qy - ay) <= 1)
                           & ((qx - ax) >= 0) & ((qx - ax) <= 1))[::-1]
        if not len(p):
            continue
        ty = np.maximum(f32(1) - np.abs(m0[p] - (qy - py[p]).astype(f32)),
                        f32(0))
        tx = np.maximum(f32(1) - np.abs(m1[p] - (qx - px[p]).astype(f32)),
                        f32(0))
        terms = (ty * tx)[None] * gg[:planes, p]
        out[i] = np.cumsum(terms, axis=1, dtype=f32)[:, -1]
    return out


def served_clamped_inputs(H, W, dev):
    """``(stack, motion, g)``: KG's and KGb's inputs on the served frame,
    the planar history stack and the motion of the ninth orbit frame
    through this tree's pipeline with ``max_motion=None`` (phase 11(c)),
    and a seeded cotangent."""
    from ..ops.temporal import history_stack
    gbuf, hist = served_inputs(H, W, dev, unbounded=True)
    return (history_stack(hist), gbuf.motion,
            _cotangent(np.random.default_rng(14), H, W, dev))
