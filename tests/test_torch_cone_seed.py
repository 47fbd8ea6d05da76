"""The port's cone pre-march seed (``RaymarchParams.coarse_seed``): the
plain twins of K15 and of the seeded K7 against the JAX package.

* The coarse stops of ``cone_seed_coarse`` (from ray planes) and
  ``cone_seed_coarse_analytic`` (from the camera, at window origin (0, 0)
  and at a non-zero one) against the interpret-mode Pallas kernels
  ``_cone_seed_coarse`` / ``_cone_seed_coarse_analytic`` on their
  ``[:Hc, :Wc]`` cells, atol 1e-4 and rtol 5e-4: XLA:CPU fuses the
  march's multiply-adds, which PyTorch rounds one by one, and an ulp a
  step accumulates over the march (observed up to 1.8e-5 on the random
  scene's planes at 48x64; one analytic cone that grazes a box there takes
  many short steps and ends 3.2e-4 (1.2e-4 relative) away).  delta
  against JAX's glue (its jnp lines) at rtol 1e-6 (sums of 16 values in
  another order); base, 0 for a pinhole camera's planes, at atol 1e-6
  (XLA's mean of 16 equal origins is off by a few ulps, 2.4e-7 observed;
  the port's is exact).
* The seeded march, by the properties of ``tests/test_raymarch.py``'s
  cone-seed tests: the SDF at each non-escaped seed is at least
  0.5·hit_eps (the seed skips no surface), hits agree with the unseeded
  march on more than 99.8 % of the pixels, the 99th percentile of |Δt| on
  pixels that hit in both is under 2·hit_eps (both stop inside the hit_eps
  shell), and the seed never exceeds the final t by more than 1e-5.
* ``render_gbuffer(impl="auto", coarse_seed=True)`` on CPU tensors against
  JAX's ``render_gbuffer(impl="pallas", interpret=True,
  normal_impl="pallas", coarse_seed=True)``.  The two seeds differ (JAX
  starts a 32x256 band at its smallest cone stop, the port each pixel at
  its own block's), so the marches stop at different points of the hit_eps
  shell: the G-buffers are held by the same properties — at most 0.2 % of
  the pixels may flip their hit or material; on the others the 99th
  percentile of |Δ| is under 2·hit_eps for the depth, 2e-3 for the
  render, 5e-3 for the normal and the motion (pixels; the shell's shift
  seen through the reprojection), and the albedo is equal.
* ``impl="plain"`` ignores the flag, as JAX's ``impl="jnp"`` does: bit for
  bit the unseeded plain render.

Shapes 48x64 and 45x62 (not a multiple of the 4-pixel block).  The CUDA
kernels are held to these twins on the card (``tests/test_torch_cuda.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import CameraParams as JCameraParams
from raymarchdenoisercuda_tpu.config import RaymarchParams as JRaymarchParams
from raymarchdenoisercuda_tpu.io.generate import orbit_camera as j_orbit
from raymarchdenoisercuda_tpu.ops.pallas.raymarch_tpu import (
    _cone_seed_coarse, _cone_seed_coarse_analytic)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import CameraParams, RaymarchParams
from raymarchdenoisercuda_torch.ops import raymarch as trm
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    cone_seed_cuda, march_gbuf_cuda, march_gbuf_seeded_cuda)

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The marches here are hundreds of small operations on a few thousand
    pixels: one intra-op thread runs them as fast, and does not contend
    with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPES = [(48, 64), (45, 62)]
SCENES = ["cornell", "random"]
HIT_EPS = RaymarchParams().hit_eps
PLANES = ("render", "albedo", "normal", "depth", "motion")


def _jscene(name):
    return (jrm.cornell_scene() if name == "cornell" else
            jrm.random_scene(n_spheres=12, n_boxes=12, n_materials=10,
                             seed=3))


def _port(jobj):
    return convert.fields_to_numpy(jobj)


def _setup(scene_name, H, W):
    jscene = _jscene(scene_name)
    jcam = j_orbit(0.25)
    scene = convert.scene_from_numpy(_port(jscene), "cpu")
    cam = convert.camera_from_numpy(_port(jcam), "cpu")
    ro, rd, _ = trm.camera_rays(cam, CameraParams(width=W, height=H))
    return jscene, jcam, scene, cam, ro, rd


def _jax_deviations(ro, rd):
    """delta and base as ``_cone_seed_coarse`` computes them (its lines)."""
    B = 4
    H, W = ro.shape[-2:]
    Hc, Wc = -(-H // B), -(-W // B)
    pad = ((0, 0), (0, B * Hc - H), (0, B * Wc - W))
    rop = jnp.pad(ro, pad, mode="edge")
    rdp = jnp.pad(rd, pad, mode="edge")
    ro_avg = rop.reshape(3, Hc, B, Wc, B).mean(axis=(2, 4))
    rd_sum = rdp.reshape(3, Hc, B, Wc, B).sum(axis=(2, 4))
    rd_avg = rd_sum / jnp.maximum(
        jnp.sqrt(jnp.sum(rd_sum * rd_sum, axis=0, keepdims=True)), 1e-8)

    def up(x):
        return jnp.repeat(jnp.repeat(x, B, axis=-2), B, axis=-1)

    def dev(full, centre):
        return jnp.sqrt(jnp.max(jnp.sum((full - up(centre)) ** 2, axis=0)))

    return float(dev(rdp, rd_avg)), float(dev(rop, ro_avg))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scene_name", SCENES)
def test_plane_seed_matches_jax_interpret(scene_name, shape):
    H, W = shape
    jscene, _jcam, scene, _cam, ro, rd = _setup(scene_name, H, W)
    params = RaymarchParams(coarse_seed=True)
    t_c, delta, base = trm.cone_seed_coarse(scene, ro, rd, params)
    Hc, Wc = trm.seed_grid_shape(H, W)
    assert t_c.shape == (Hc, Wc)
    jro, jrd = jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())
    want = np.asarray(_cone_seed_coarse(
        jscene, jro, jrd, JRaymarchParams(coarse_seed=True), interpret=True))
    np.testing.assert_allclose(t_c.numpy(), want[:Hc, :Wc], rtol=5e-4,
                               atol=1e-4)
    j_delta, j_base = _jax_deviations(jro, jrd)
    np.testing.assert_allclose(float(delta), j_delta, rtol=1e-6)
    np.testing.assert_allclose(float(base), j_base, rtol=0, atol=1e-6)
    assert float(delta) > 0.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scene_name", SCENES)
def test_analytic_seed_matches_jax_interpret(scene_name, shape):
    """A window of a larger frame at origin (0, 0) and at (8, 12)."""
    th, tw = shape
    jscene, jcam, scene, cam, _ro, _rd = _setup(scene_name, th, tw)
    cfg, jcfg = CameraParams(width=96, height=80), JCameraParams(width=96,
                                                                 height=80)
    params = RaymarchParams(coarse_seed=True)
    Hc, Wc = trm.seed_grid_shape(th, tw)
    for row0, col0 in ((0, 0), (8, 12)):
        t_c, delta, base = trm.cone_seed_coarse_analytic(
            scene, cam, cfg, row0, col0, th, tw, params)
        want = np.asarray(_cone_seed_coarse_analytic(
            jscene, jcam, jcfg, row0, col0, th, tw,
            JRaymarchParams(coarse_seed=True), interpret=True))
        np.testing.assert_allclose(t_c.numpy(), want[:Hc, :Wc], rtol=5e-4,
                                   atol=1e-4, err_msg=f"({row0}, {col0})")
        assert float(base) == 0.0 and float(delta) > 0.0


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("route", ["planes", "camera"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scene_name", SCENES)
def test_seeded_march_properties(scene_name, shape, route, omega):
    """``march_gbuf_cuda`` with ``coarse_seed`` on CPU tensors (the plain
    twins of K15 and the seeded K7) against the unseeded march."""
    H, W = shape
    _js, _jc, scene, cam, ro, rd = _setup(scene_name, H, W)
    cfg = CameraParams(width=W, height=H)
    p0 = RaymarchParams(relax_omega=omega)
    p1 = RaymarchParams(relax_omega=omega, coarse_seed=True)
    kw = (dict(camera=cam, cam_cfg=cfg, shape=(H, W)) if route == "camera"
          else {})
    t_c = cone_seed_cuda(scene, p1, ro, rd, **kw)[0]
    seed = trm.seed_plane(t_c, H, W)
    d_at = trm.sdf_scene(scene, ro + seed[None] * rd, want_mat=False)
    live = seed < p1.max_dist
    assert bool(live.any())
    assert float(d_at[live].min()) >= 0.5 * HIT_EPS

    t0, h0, m0, _n0 = march_gbuf_cuda(scene, ro, rd, p0)
    mkw = dict(camera=cam, cam_cfg=cfg) if route == "camera" else {}
    t1, h1, m1, _n1 = march_gbuf_cuda(scene, ro, rd, p1, **mkw)
    assert float((h0 == h1).float().mean()) > 0.998
    both = h0 & h1
    dt = (t0 - t1).abs()[both].numpy()
    assert np.percentile(dt, 99) < 2 * HIT_EPS, np.percentile(dt, 99)
    assert bool((seed <= t1 + 1e-5).all())
    # the same stops through the explicit-seed entry point
    again = march_gbuf_seeded_cuda(scene, ro, rd, t_c, p1)
    assert torch.equal(again[0], t1) and torch.equal(again[2], m1)


def test_seeded_render_matches_jax_interpret():
    """Cornell (the interpret-mode render costs seconds; the random scene's
    seeds and march are held above)."""
    scene_name = "cornell"
    H, W = 48, 64
    rm = dict(max_steps=48, shadow_steps=24)
    jscene = _jscene(scene_name)
    jcam, jprev = j_orbit(0.25), j_orbit(0.1875)
    key = jax.random.PRNGKey(7)
    want = _port(jrm.render_gbuffer(
        jscene, jcam, jprev, key, cam_cfg=JCameraParams(width=W, height=H),
        params=JRaymarchParams(coarse_seed=True, **rm), impl="pallas",
        interpret=True, normal_impl="pallas"))
    lp = torch.tensor(np.asarray(jrm.sample_light(
        jscene, jax.random.split(key, 1)[0], (H, W))))
    scene = convert.scene_from_numpy(_port(jscene), "cpu")
    got = convert.gbuffer_to_numpy(trm.render_gbuffer(
        scene, convert.camera_from_numpy(_port(jcam), "cpu"),
        convert.camera_from_numpy(_port(jprev), "cpu"),
        cam_cfg=CameraParams(width=W, height=H),
        params=RaymarchParams(coarse_seed=True, **rm), light_sample=lp))
    flipped = ((np.abs(got["albedo"] - want["albedo"]).max(0) > 0)
               | ((got["depth"] > 0) != (want["depth"] > 0)))
    assert flipped.mean() <= 2e-3, int(flipped.sum())
    keep = ~flipped
    np.testing.assert_array_equal(got["albedo"][:, keep],
                                  want["albedo"][:, keep])
    for name, bound in (("depth", 2 * HIT_EPS), ("render", 2e-3),
                        ("normal", 5e-3), ("motion", 5e-3)):
        d = np.abs(got[name] - want[name])[..., keep]
        assert np.percentile(d, 99) < bound, (name, np.percentile(d, 99))


def test_plain_render_ignores_coarse_seed():
    scene = trm.cornell_scene(device="cpu")
    cam, prev = trm.cornell_camera(device="cpu"), None
    cfg = CameraParams(width=30, height=22)
    lp = trm.sample_light(scene, torch.Generator().manual_seed(0), (22, 30))
    a, b = (trm.render_gbuffer(scene, cam, prev, cam_cfg=cfg,
                               params=RaymarchParams(max_steps=32,
                                                     coarse_seed=seeded),
                               light_sample=lp, impl="plain")
            for seeded in (True, False))
    for name in PLANES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_seeded_wrappers_launch_nothing_on_the_cpu():
    scene = trm.cornell_scene(device="cpu")
    cam = trm.cornell_camera(device="cpu")
    cfg = CameraParams(width=20, height=14)
    counts = (cone_seed_cuda.launches, march_gbuf_seeded_cuda.launches,
              march_gbuf_cuda.launches)
    out = trm.render_gbuffer(scene, cam, None, cam_cfg=cfg,
                             params=RaymarchParams(coarse_seed=True))
    assert out.depth.shape == (14, 20)
    assert counts == (cone_seed_cuda.launches,
                      march_gbuf_seeded_cuda.launches,
                      march_gbuf_cuda.launches)
    # the seeded march is differentiable (the implicit-function adjoint,
    # the seed held constant), and still launches nothing here
    ro, rd, _ = trm.camera_rays(cam, cfg)
    t, _hit, _mat, n = march_gbuf_cuda(scene, ro, rd.requires_grad_(),
                                       RaymarchParams(coarse_seed=True))
    (t.sum() + n.sum()).backward()
    assert bool(torch.isfinite(rd.grad).all())
    assert float(rd.grad.abs().max()) > 0
    assert counts == (cone_seed_cuda.launches,
                      march_gbuf_seeded_cuda.launches,
                      march_gbuf_cuda.launches)
