"""The port's raymarcher (K7/K8 plain versions, reached through their
wrappers on CPU tensors) against the JAX package's ``render_gbuffer``
(``impl="jnp"``).

torch cannot reproduce ``jax.random``'s threefry stream, so the port is
handed the light sample that the JAX renderer draws from the same key.

Tolerances:
* render, albedo, depth, motion: atol 1e-4 (``tests/test_raymarch.py``'s
  bound for the TPU kernels vs the jnp path);
* normal: atol 5e-4, rtol 5e-3, the JAX package's own bound for kernel
  normals vs XLA normals (``test_march_kernel_normals_parity_interpret``).
  XLA fuses multiply-adds that PyTorch rounds separately, so hit points
  differ by an ulp; where the central-difference stencil straddles an edge
  between two primitives the normal amplifies that ~1000x (observed up to
  2.7e-4 on a few pixels of a 48x64 frame);
* a pixel whose hit mask or material id flips on such an ulp (silhouettes,
  edges where two primitives are equally near) differs by a whole material:
  at most 0.1 % of pixels may do so, and they are left out of the plane
  comparison.
The spp > 1 render (the plain twin of K13 once per light sample, the direct
light summed in PyTorch) is held to JAX's at the same bounds, the render
plane at atol 1e-4 and rtol 1e-5.  An rtol of 1e-5 alone does not hold:
the hit points differ by an ulp (XLA's fused multiply-adds in the march),
and the shading's geometry term carries that into the render, up to
9.6e-5 relative (1.1e-5 absolute) at spp = 1 and 7.6e-5 (2.6e-5) at
spp = 4 on the 48x64 Cornell frame.  A pixel whose visibility flips on
one sample may leave the bound, within the same 0.1 %.  ``shadow_factor`` itself is held to JAX's ``_shadow_factor`` and to
``shadow_factor_pallas(interpret=True)`` on the same hit points: at most
0.1 % of the visibilities may flip.
The CUDA kernels are held to the plain versions on the card the same way
(``tests/test_torch_cuda.py``).
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
    shadow_factor_pallas)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import CameraParams, RaymarchParams
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.ops import raymarch as trm

# the package re-exports the function ``raymarch`` under the module's name
jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")

H, W = 48, 64
RM = dict(max_steps=48, shadow_steps=24)
PLANES = ("render", "albedo", "normal", "depth", "motion")


def _jax_light_sample(scene, key):
    # the split render_gbuffer makes for its single light sample
    return np.asarray(jrm.sample_light(scene, jax.random.split(key, 1)[0],
                                       (H, W)))


def _compare_gbuffers(got, want, what):
    """Planes agree (tolerances in the module docstring) except at pixels
    whose hit or material flipped, which must be at most 0.1 % of the
    frame."""
    flipped = np.zeros(want["depth"].shape, bool)
    for name in ("albedo", "depth"):
        d = np.abs(got[name] - want[name])
        flipped |= (d.max(0) if d.ndim == 3 else d) > 1e-4
    assert flipped.mean() <= 1e-3, (what, int(flipped.sum()))
    for name in PLANES:
        a, b = got[name], want[name]
        tol = (dict(rtol=5e-3, atol=5e-4) if name == "normal"
               else dict(rtol=0, atol=1e-4))
        np.testing.assert_allclose(a[..., ~flipped], b[..., ~flipped],
                                   err_msg=f"{what}:{name}", **tol)


def _scenes():
    return {"cornell": jrm.cornell_scene(),
            "random": jrm.random_scene(n_spheres=12, n_boxes=12,
                                       n_materials=10, seed=3)}


@pytest.mark.parametrize("scene_name", ["cornell", "random"])
@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_render_gbuffer_matches_jax(scene_name, omega):
    jscene = _scenes()[scene_name]
    jcam, jprev = j_orbit(0.25), j_orbit(0.1875)
    key = jax.random.PRNGKey(7)
    cfg = dict(width=W, height=H)
    want = jrm.render_gbuffer(jscene, jcam, jprev, key,
                              cam_cfg=JCameraParams(**cfg),
                              params=JRaymarchParams(relax_omega=omega, **RM))
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    lp = torch.tensor(_jax_light_sample(jscene, key))
    got = trm.render_gbuffer(
        scene, convert.camera_from_numpy(convert.fields_to_numpy(jcam), "cpu"),
        convert.camera_from_numpy(convert.fields_to_numpy(jprev), "cpu"),
        cam_cfg=CameraParams(**cfg),
        params=RaymarchParams(relax_omega=omega, **RM), light_sample=lp)
    _compare_gbuffers(convert.gbuffer_to_numpy(got),
                      convert.fields_to_numpy(want), scene_name)


def test_scene_builders_match_jax():
    for want, got in ((jrm.cornell_scene(), trm.cornell_scene(device="cpu")),
                      (jrm.random_scene(seed=5),
                       trm.random_scene(seed=5, device="cpu"))):
        w = convert.fields_to_numpy(want)
        g = convert.fields_to_numpy(got)
        for name in w:
            if name == "materials":
                for m in ("albedo", "emission"):
                    np.testing.assert_array_equal(g[name][m], w[name][m])
            else:
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for t in (0.0, 0.3):
        np.testing.assert_array_equal(
            convert.fields_to_numpy(orbit_camera(t, device="cpu"))["position"],
            convert.fields_to_numpy(j_orbit(t))["position"])


def test_camera_rays_and_sdf_match_jax():
    jcam = jrm.cornell_camera()
    ro, rd, _ = trm.camera_rays(trm.cornell_camera(device="cpu"),
                                CameraParams(width=W, height=H))
    jro, jrd, _ = jrm.camera_rays(jcam, JCameraParams(width=W, height=H))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-7)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)
    p = np.random.default_rng(0).uniform(-0.9, 0.9, (3, 8, 8)).astype(
        np.float32)
    scene = trm.cornell_scene(device="cpu")
    d, mat = trm.sdf_scene(scene, torch.from_numpy(p))
    jd, jmat = jrm.sdf_scene(jrm.cornell_scene(), jnp.asarray(p))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    n = trm.sdf_normal(scene, torch.from_numpy(p))
    np.testing.assert_allclose(
        n.numpy(), np.asarray(jrm.sdf_normal(jrm.cornell_scene(),
                                             jnp.asarray(p))), atol=1e-4)


def test_first_frame_has_zero_motion_and_light_draw_is_seeded():
    scene = trm.cornell_scene(device="cpu")
    cam = trm.cornell_camera(device="cpu")
    cfg = CameraParams(width=32, height=24)
    rm = RaymarchParams(**RM)
    a = trm.render_gbuffer(scene, cam, None, torch.Generator().manual_seed(1),
                           cam_cfg=cfg, params=rm)
    b = trm.render_gbuffer(scene, cam, None, torch.Generator().manual_seed(1),
                           cam_cfg=cfg, params=rm)
    c = trm.render_gbuffer(scene, cam, None, torch.Generator().manual_seed(2),
                           cam_cfg=cfg, params=rm)
    assert float(a.motion.abs().max()) == 0.0
    assert torch.equal(a.render, b.render)
    assert not torch.equal(a.render, c.render)
    assert torch.equal(a.albedo, c.albedo)


@pytest.mark.parametrize("scene_name", ["cornell", "random"])
@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_shadow_factor_matches_jax_and_pallas(scene_name, omega):
    jscene = _scenes()[scene_name]
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    params = RaymarchParams(relax_omega=omega, **RM)
    jparams = JRaymarchParams(relax_omega=omega, **RM)
    # hit points and normals of the port's march, a light sample from numpy
    ro, rd, _ = trm.camera_rays(
        convert.camera_from_numpy(convert.fields_to_numpy(j_orbit(0.25)),
                                  "cpu"), CameraParams(width=W, height=H))
    t, _hit, _mat, n = trm.march_gbuf(scene, ro, rd, params)
    p = ro + t[None] * rd
    u = np.random.default_rng(5).uniform(-1, 1, (2, H, W)).astype(np.float32)
    lp = (scene.light_center[:, None, None]
          + scene.light_u[:, None, None] * torch.from_numpy(u[0])[None]
          + scene.light_v[:, None, None] * torch.from_numpy(u[1])[None])
    got = trm.shadow_factor(scene, p, n, lp, params).numpy()
    assert got.shape == (H, W) and set(np.unique(got)) <= {0.0, 1.0}
    assert 0.0 < got.mean() < 1.0          # shadowed and lit pixels alike
    args = (jnp.asarray(p.numpy()), jnp.asarray(n.numpy()),
            jnp.asarray(lp.numpy()))
    for want in (jrm._shadow_factor(jscene, *args, jparams),
                 shadow_factor_pallas(jscene, *args, jparams,
                                      interpret=True)):
        assert (got != np.asarray(want)).mean() <= 1e-3


@pytest.mark.parametrize("scene_name", ["cornell", "random"])
def test_render_gbuffer_spp_matches_jax(scene_name):
    jscene = _scenes()[scene_name]
    jcam, jprev = j_orbit(0.25), j_orbit(0.1875)
    key = jax.random.PRNGKey(11)
    cfg = dict(width=W, height=H)
    want = convert.fields_to_numpy(jrm.render_gbuffer(
        jscene, jcam, jprev, key, cam_cfg=JCameraParams(**cfg),
        params=JRaymarchParams(**RM), spp=4))
    # the samples render_gbuffer draws: one key of split(key, spp) each
    lp = np.stack([np.asarray(jrm.sample_light(jscene, k, (H, W)))
                   for k in jax.random.split(key, 4)])
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    got = convert.gbuffer_to_numpy(trm.render_gbuffer(
        scene, convert.camera_from_numpy(convert.fields_to_numpy(jcam), "cpu"),
        convert.camera_from_numpy(convert.fields_to_numpy(jprev), "cpu"),
        cam_cfg=CameraParams(**cfg), params=RaymarchParams(**RM),
        light_sample=torch.from_numpy(lp), spp=4))
    a, b = got["render"], want["render"]
    flipped = (np.abs(a - b) > 1e-4 + 1e-5 * np.abs(b)).any(0)
    for name in ("albedo", "depth"):
        d = np.abs(got[name] - want[name])
        flipped |= (d.max(0) if d.ndim == 3 else d) > 1e-4
    assert flipped.mean() <= 1e-3, int(flipped.sum())
    np.testing.assert_allclose(a[..., ~flipped], b[..., ~flipped], rtol=1e-5,
                               atol=1e-4)
    got["render"], want["render"] = a * 0, b * 0   # compared above
    _compare_gbuffers(got, want, f"{scene_name} spp=4")


def test_render_gbuffer_spp_draws_and_checks_samples():
    scene = trm.cornell_scene(device="cpu")
    cam = trm.cornell_camera(device="cpu")
    cfg = CameraParams(width=16, height=12)
    rm = RaymarchParams(**RM)
    a = trm.render_gbuffer(scene, cam, None, torch.Generator().manual_seed(3),
                           cam_cfg=cfg, params=rm, spp=3)
    # the generator's draws, one sample after the other
    g = torch.Generator().manual_seed(3)
    lp = torch.stack([trm.sample_light(scene, g, (12, 16)) for _ in range(3)])
    b = trm.render_gbuffer(scene, cam, None, cam_cfg=cfg, params=rm,
                           light_sample=lp, spp=3)
    assert torch.equal(a.render, b.render)
    # one sample at spp = 1 is the K8 path; the spp path agrees with it
    one = trm.render_gbuffer(scene, cam, None, cam_cfg=cfg, params=rm,
                             light_sample=lp[0])
    spp1 = trm.render_gbuffer(scene, cam, None, cam_cfg=cfg, params=rm,
                              light_sample=lp[:1], spp=1)
    assert torch.equal(one.render, spp1.render)
    with pytest.raises(ValueError, match="light_sample"):
        trm.render_gbuffer(scene, cam, None, cam_cfg=cfg, params=rm,
                           light_sample=lp, spp=2)
    with pytest.raises(ValueError, match="spp"):
        trm.render_gbuffer(scene, cam, None, cam_cfg=cfg, params=rm, spp=0)


def test_constructors_default_to_the_card():
    constructors = (trm.cornell_scene, trm.random_scene, trm.cornell_camera,
                lambda: trm.make_camera([0.0, 0.0, -1.0]),
                lambda: orbit_camera(0.1))
    for make in constructors:
        if torch.cuda.is_available():
            obj = make()
            first = getattr(obj, "sphere_params", None)
            first = first if first is not None else obj.position
            assert first.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
