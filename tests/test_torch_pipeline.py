"""The whole slice: render + denoise the first frames of the animated
Cornell sequence through the port's ``render_and_denoise`` and the JAX
package's (``impl="reference"``), threading the history through both.

Tolerance: ``denoised`` and every History plane agree to atol 1e-4·max|ref|
per frame, except ``prev_normal``, which is the frame's G-buffer normal and
is held to the normal bound of ``tests/test_torch_raymarch.py`` (atol 5e-4,
rtol 5e-3: central differences across an edge between two primitives
amplify a 1-ulp hit-point difference).  The port is handed the light
samples the JAX renderer draws (torch cannot reproduce threefry).

Exact geometric ties are the one exception.  In frame 0 the camera sits on
the box's axis, and at 48x64 four rays land exactly on the bisector of the
floor and a side wall: the two distances are equal, and which material wins
is decided by the last bit of the ray direction, which XLA's fused code and
PyTorch round differently.  Such a pixel is found by comparing the two
packages' G-buffers (albedo or depth apart by more than 1e-4); at most
0.2 % of a frame may be one, and the comparison leaves out the tie pixels
of this and earlier frames, grown by 2 pixels for the reprojection.

The CUDA path is held to the plain path on the card by ``chip_smoke.py``
and by ``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import numpy as np
import torch

from raymarchdenoisercuda_tpu.config import (
    CameraParams as JCameraParams, RaymarchParams as JRaymarchParams,
    SVGFParams as JSVGFParams)
from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.io.generate import orbit_camera as j_orbit
from raymarchdenoisercuda_tpu.models.pipeline import (
    render_and_denoise as j_render_and_denoise)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import (
    FramePipeline, render_and_denoise)
from raymarchdenoisercuda_torch.ops import raymarch as trm

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")

H, W = 48, 64
FRAMES = 3
SEQ = 16          # the frames are the first of a 16-frame orbit
RM = dict(max_steps=48, shadow_steps=24)


def _close(got, want, keep, what, normal=False):
    tol = (dict(rtol=5e-3, atol=5e-4) if normal
           else dict(rtol=0, atol=1e-4 * float(np.abs(want).max())))
    np.testing.assert_allclose(got[..., keep], want[..., keep],
                               err_msg=what, **tol)


def _grow(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


def test_slice_matches_jax_over_three_frames():
    jscene = jrm.cornell_scene()
    jcfg = dict(cam_cfg=JCameraParams(width=W, height=H),
                rm_params=JRaymarchParams(**RM), svgf_params=JSVGFParams())
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    cfg = dict(cam_cfg=CameraParams(width=W, height=H),
               rm_params=RaymarchParams(**RM), svgf_params=SVGFParams())

    key = jax.random.PRNGKey(0)
    jhist = JHistory.zeros(H, W)
    hist = History.zeros(H, W, device="cpu")
    jprev = prev = None
    tainted = np.zeros((H, W), bool)
    for f in range(FRAMES):
        key, sub = jax.random.split(key)
        jcam, cam = j_orbit(f / SEQ), orbit_camera(f / SEQ)
        jout, jhist = j_render_and_denoise(jscene, jcam, jprev, jhist, sub,
                                           impl="reference", **jcfg)
        lp = torch.tensor(np.asarray(jrm.sample_light(
            jscene, jax.random.split(sub, 1)[0], (H, W))))
        out, hist = render_and_denoise(scene, cam, prev, hist,
                                       light_sample=lp, **cfg)
        ties = ((np.abs(out.albedo.numpy() - np.asarray(jout.albedo)).max(0)
                 > 1e-4)
                | (np.abs(out.depth.numpy() - np.asarray(jout.depth)) > 1e-4))
        assert ties.mean() <= 2e-3, (f, int(ties.sum()))
        tainted |= _grow(ties, 2)
        keep = ~tainted
        _close(out.denoised.numpy(), np.asarray(jout.denoised), keep,
               f"frame {f}: denoised")
        want = convert.fields_to_numpy(jhist)
        for name, plane in convert.history_to_numpy(hist).items():
            _close(plane, want[name], keep, f"frame {f}: history.{name}",
                   normal=name == "prev_normal")
        jprev, prev = jcam, cam


def test_denoise_sequence_matches_jax():
    """``svgf_denoise_sequence`` threads the history as the reference does
    (fixed G-buffers, so no geometric ties: the plain 1e-4·max bound)."""
    from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
    from raymarchdenoisercuda_tpu.models.svgf import (
        svgf_denoise_sequence as j_sequence)
    from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_sequence

    rng = np.random.default_rng(2)
    h, w = 24, 32
    n = rng.standard_normal((3, h, w)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    frames = [dict(render=rng.random((3, h, w), dtype=np.float32),
                   albedo=(0.2 + 0.6 * rng.random((3, h, w))).astype(
                       np.float32),
                   normal=n, depth=np.full((h, w), 0.5, np.float32),
                   motion=np.full((2, h, w), 0.6, np.float32))
              for _ in range(3)]
    params = dict(iterations=3, radius=1)
    want = list(j_sequence([JGBuffer(**f) for f in frames],
                           params=JSVGFParams(**params)))
    got = list(svgf_denoise_sequence(
        [convert.gbuffer_from_numpy(f, "cpu") for f in frames],
        params=SVGFParams(**params)))
    for f, (a, b) in enumerate(zip(got, want)):
        _close(a.denoised.numpy(), np.asarray(b.denoised),
               np.ones((h, w), bool), f"frame {f}: denoised")


def test_frame_pipeline_module_matches_function():
    scene = trm.cornell_scene()
    cfg = CameraParams(width=32, height=24)
    rm = RaymarchParams(**RM)
    sv = SVGFParams(radius=1, iterations=3)
    module = FramePipeline(scene, cfg, rm, sv, weight_math="fast")
    hist_m = hist_f = History.zeros(24, 32, device="cpu")
    prev = None
    for f in range(2):
        cam = orbit_camera(f / SEQ)
        a, hist_m = module(cam, prev, hist_m, torch.Generator().manual_seed(f))
        b, hist_f = render_and_denoise(
            scene, cam, prev, hist_f, torch.Generator().manual_seed(f),
            cam_cfg=cfg, rm_params=rm, svgf_params=sv, weight_math="fast")
        assert torch.equal(a.denoised, b.denoised)
        assert torch.isfinite(a.denoised).all()
        prev = cam
    assert torch.equal(hist_m.length, hist_f.length)
    assert float(hist_m.length.max()) == 2.0
