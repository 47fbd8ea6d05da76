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
    for want, got in ((jrm.cornell_scene(), trm.cornell_scene()),
                      (jrm.random_scene(seed=5), trm.random_scene(seed=5))):
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
            convert.fields_to_numpy(orbit_camera(t))["position"],
            convert.fields_to_numpy(j_orbit(t))["position"])


def test_camera_rays_and_sdf_match_jax():
    jcam = jrm.cornell_camera()
    ro, rd, _ = trm.camera_rays(trm.cornell_camera(),
                                CameraParams(width=W, height=H))
    jro, jrd, _ = jrm.camera_rays(jcam, JCameraParams(width=W, height=H))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-7)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)
    p = np.random.default_rng(0).uniform(-0.9, 0.9, (3, 8, 8)).astype(
        np.float32)
    d, mat = trm.sdf_scene(trm.cornell_scene(), torch.from_numpy(p))
    jd, jmat = jrm.sdf_scene(jrm.cornell_scene(), jnp.asarray(p))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    n = trm.sdf_normal(trm.cornell_scene(), torch.from_numpy(p))
    np.testing.assert_allclose(
        n.numpy(), np.asarray(jrm.sdf_normal(jrm.cornell_scene(),
                                             jnp.asarray(p))), atol=1e-4)


def test_first_frame_has_zero_motion_and_light_draw_is_seeded():
    scene = trm.cornell_scene()
    cam = trm.cornell_camera()
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
