"""The port's denoiser-quality gate (``utils/denoise_quality.py``), the
counterpart of ``tests/test_quality.py`` over ``tools/denoise_quality.py``.

* ``psnr`` and ``ssim`` equal the JAX tool's on the same arrays (1e-6).
* The denoiser alone: the port's ``score`` on frames and references that
  the JAX package rendered (the JAX tool's render loop, its keys, carried
  across by ``convert``) reproduces the JAX tool's ``run_eval`` metrics
  within 0.01 dB and 1e-4 SSIM (the tool rounds to those digits), at
  64², 6 frames, 32-sample references, warm-up 2.
* The gate: the port renders its own sequences (torch's generator is not
  threefry, so the noise differs from JAX's) and holds
  ``tests/test_quality.py``'s configurations and thresholds.  Cornell,
  160², 8 frames, 256-sample references, warm-up 3, exact weights: r2
  with 4 iterations and r1 with 5, gain > 2.2 dB and output SSIM > 0.96
  and > input + 0.05; r1 with luma-only deep levels from 3, gain > 2.6
  dB and SSIM > 0.95.  The clutter scene (192², 10 frames, warm-up 4;
  ``slow``, as the JAX package marks it): r1 gain > -0.3 dB, SSIM > 0.945
  and > input + 0.10, and luma-only from 3 more than 0.015 SSIM below
  r1.  One rendered sequence serves every setting of a scene.

The renders are hundreds of small operations on a few thousand pixels:
one torch thread runs them as fast and leaves the other workers their
cores (the Cornell sequence takes 80-140 s on one CPU thread).
"""

import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import CameraParams as JCameraParams
from raymarchdenoisercuda_tpu.config import RaymarchParams as JRaymarchParams
from raymarchdenoisercuda_tpu.io.generate import orbit_camera as j_orbit
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.utils import denoise_quality as dq

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import denoise_quality as jdq  # noqa: E402  (tools/denoise_quality.py)

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_psnr_and_ssim_equal_the_jax_tools():
    rng = np.random.default_rng(0)
    a = rng.random((3, 40, 52))
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    for fn, jfn in ((dq.psnr, jdq.psnr), (dq.ssim, jdq.ssim)):
        for x, y in ((a, b), (a.astype(np.float32), b), (b, b)):
            assert abs(fn(x, y) - jfn(x, y)) <= 1e-6


def test_score_reproduces_jax_run_eval_on_jax_frames(one_thread):
    """The JAX tool's render loop (keys split three ways a frame) gives the
    frames; the port denoises them.  Any gap is the denoiser's."""
    size, frames, spp_ref, warmup = 64, 6, 32, 2
    want = jdq.run_eval(size=size, frames=frames, spp_ref=spp_ref,
                        warmup=warmup, impl="reference")
    scene = jrm.cornell_scene()
    cfg = JCameraParams(width=size, height=size)
    rm = JRaymarchParams()
    key = jax.random.PRNGKey(0)
    seq_frames, refs, prev = [], {}, None
    for f in range(frames):
        cam = j_orbit(f / frames)
        key, k_noisy, k_ref = jax.random.split(key, 3)
        g = jrm.render_gbuffer(scene, cam, prev, k_noisy, cam_cfg=cfg,
                               params=rm, spp=1, impl="jnp")
        seq_frames.append(convert.gbuffer_from_numpy(
            convert.fields_to_numpy(g), "cpu"))
        if f >= warmup:
            ref = jrm.render_gbuffer(scene, cam, None, k_ref, cam_cfg=cfg,
                                     params=rm, spp=spp_ref, impl="jnp")
            refs[f] = np.clip(np.asarray(ref.render), 0, 1)
        prev = cam
    got = dq.score(dq.Sequence(seq_frames, refs, warmup, "JAX frames"))
    for k in ("input_psnr_db", "output_psnr_db", "psnr_gain_db"):
        assert abs(got[k] - want[k]) <= 0.01 + 1e-9, (k, got, want)
    for k in ("input_ssim", "output_ssim"):
        assert abs(got[k] - want[k]) <= 1e-4 + 1e-12, (k, got, want)


@pytest.fixture(scope="module")
def cornell(one_thread):
    return dq.render_sequence(size=160, frames=8, spp_ref=256, warmup=3,
                              device="cpu")


@pytest.fixture(scope="module")
def quality(cornell):
    return dq.score(cornell, iterations=4, radius=2)


@pytest.fixture(scope="module")
def quality_r1(cornell):
    return dq.score(cornell, iterations=5, radius=1)


def test_denoiser_improves_psnr(quality):
    assert quality["psnr_gain_db"] > 2.2, quality


def test_denoiser_improves_ssim(quality):
    assert quality["output_ssim"] > 0.96, quality
    assert quality["output_ssim"] > quality["input_ssim"] + 0.05, quality


def test_denoiser_quality_radius1_mode(quality_r1):
    assert quality_r1["psnr_gain_db"] > 2.2, quality_r1
    assert quality_r1["output_ssim"] > 0.96, quality_r1
    assert quality_r1["output_ssim"] > quality_r1["input_ssim"] + 0.05, \
        quality_r1


def test_denoiser_quality_r1_luma3_mode(cornell):
    q = dq.score(cornell, iterations=5, radius=1, luma_only_from=3)
    assert q["psnr_gain_db"] > 2.6, q
    assert q["output_ssim"] > 0.95, q


def test_pyramid_from_is_not_ported(cornell):
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        dq.score(cornell, pyramid_from=3)


@pytest.fixture(scope="module")
def clutter(one_thread):
    return dq.render_sequence(size=192, frames=10, spp_ref=256, warmup=4,
                              scene_kind="clutter", device="cpu")


@pytest.fixture(scope="module")
def quality_clutter_r1(clutter):
    return dq.score(clutter, iterations=5, radius=1)


@pytest.mark.slow
def test_denoiser_quality_clutter_scene(quality_clutter_r1):
    q = quality_clutter_r1
    assert q["psnr_gain_db"] > -0.3, q
    assert q["output_ssim"] > 0.945, q
    assert q["output_ssim"] > q["input_ssim"] + 0.10, q


@pytest.mark.slow
def test_luma_mode_degrades_on_clutter(clutter, quality_clutter_r1):
    q = dq.score(clutter, iterations=5, radius=1, luma_only_from=3)
    assert q["output_ssim"] < quality_clutter_r1["output_ssim"] - 0.015, (
        q, quality_clutter_r1)
