"""The march's geometry adjoint: the port's gradients of the hit distance,
the normal and the render with respect to the scene's primitives and the
rays, against the JAX package's implicit-function VJP.

The JAX package differentiates the march at the hit point (``raymarch``
with ``_raymarch_bwd``; ``raymarch_pallas_gbuf`` with ``_gbuf_fused_bwd``
where the march emits the normal): one SDF evaluation there, not autograd
through ``max_steps`` iterations.  The port's ``_March`` Function does
the same in PyTorch, for the plain march on the CPU and for K7/K7s on the
card (``tests/test_torch_cuda.py`` holds the card's against this plain
path).

Inputs: the Cornell box with its sphere, boxes and plane offsets moved by
a seeded numpy draw of ±0.02, rays of the Cornell camera at 42 x 64 (no
pixel ties two primitives there; 44 x 60 and 34 x 64 have such pixels),
``max_steps`` 48, seeded loss weights.  Where the normal enters the loss,
the boxes are replaced by spheres: JAX's gradient of the central-difference
normal is NaN at every pixel that hits a box, because a stencil point
inside a box takes the derivative of ``jnp.linalg.norm`` at 0 (0·∞), and
that NaN reaches every scene parameter through the hit-point cotangent (on
the Cornell box at 48 x 64, 42 x 64 and 45 x 60 alike, so the JAX
package's own fused-normal test compares NaN with NaN).  The port gives
such a point the derivative 0 (its norm's derivative at 0 is 0), which is
the function's there.  Two checks hold the normal chain at box hits
against something other than the port: JAX's fused adjoint on the Cornell
box with ``jnp.linalg.norm`` replaced, for that test alone, by a norm of
derivative 0 at 0 (the same values everywhere), and central differences
of a loss of t and the normal over the box faces with respect to a box's
centre and half-size.

Tolerance: atol 2e-3·scale, scale the largest magnitude of JAX's
gradient, as the JAX package holds its fused adjoint to its unfused one
(``tests/test_raymarch.py``, ``test_march_kernel_fused_normal_gradients``):
the denominator's clamp makes grazing rays' gradients large.  The finite-difference checks
follow ``tests/test_raymarch.py``'s (the sphere's radius and centre, rtol
0.05), and the box's at the same rtol.
"""

import dataclasses
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
    raymarch_pallas_gbuf)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import CameraParams, RaymarchParams
from raymarchdenoisercuda_torch.ops import raymarch as trm

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")

H, W = 42, 64
RM = dict(max_steps=48, shadow_steps=24)
TOL = 2e-3          # atol, relative to the largest magnitude of JAX's
GEOMETRY = ("sphere_params", "box_params", "plane_params")


@pytest.fixture(autouse=True)
def one_thread():
    """Hundreds of small operations on a few thousand pixels: one
    intra-op thread runs them as fast and leaves the other workers their
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jscene(seed=0):
    """The Cornell box with its geometry moved by a seeded draw."""
    rng = np.random.default_rng(seed)
    s = jrm.cornell_scene()
    sph = np.asarray(s.sphere_params) + rng.uniform(-0.02, 0.02, (1, 4))
    box = np.asarray(s.box_params).copy()
    box[:, :3] += rng.uniform(-0.02, 0.02, (3, 3))
    pl = np.asarray(s.plane_params).copy()
    pl[:, 3] += rng.uniform(-0.02, 0.02, 5)
    return s.replace(**{k: jnp.asarray(v, jnp.float32) for k, v in zip(
        GEOMETRY, (sph, box, pl))})


def _sphere_jscene(seed):
    """:func:`_jscene` with its boxes (the light slab among them) replaced
    by spheres of their size, so that no normal stencil point lies inside
    a box."""
    s = _jscene(seed)
    box = np.asarray(s.box_params)
    sph = np.concatenate([np.asarray(s.sphere_params), np.concatenate(
        [box[:2, :3], box[:2, 3:].mean(1, keepdims=True)], 1)])
    return s.replace(
        sphere_params=jnp.asarray(sph, jnp.float32),
        sphere_mat=jnp.concatenate([s.sphere_mat, s.box_mat[:2]]),
        box_params=jnp.zeros((0, 6), jnp.float32),
        box_mat=jnp.zeros((0,), jnp.int32))


def _rays():
    ro, rd, _ = jrm.camera_rays(jrm.cornell_camera(),
                                JCameraParams(width=W, height=H))
    return np.asarray(jnp.broadcast_to(ro, rd.shape)), np.asarray(rd)


def _weights(seed, shape):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(
        np.float32)


def _leaves(jscene, *arrays):
    """The port's scene with its geometry as leaves that require grad,
    and leaves for ``arrays``."""
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    geo = [getattr(scene, k).clone().requires_grad_() for k in GEOMETRY]
    scene = dataclasses.replace(scene, **dict(zip(GEOMETRY, geo)))
    return scene, geo + [torch.tensor(a, requires_grad=True) for a in arrays]


def _assert_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0,
                                   atol=TOL * scale, err_msg=name)


def test_march_gradients_match_jax_implicit_adjoint():
    """d(Σ w·t) by the port's plain march (``march_gbuf``'s t) against
    ``jax.grad`` of JAX's ``raymarch`` for the spheres, boxes and planes,
    ro and rd.  Autograd through the loop's iterations (the port before
    the adjoint) is several per cent off on such a frame."""
    jscene = _jscene()
    ro, rd = _rays()
    w = _weights(1, (H, W))
    jp = JRaymarchParams(**RM)

    def loss(sph, box, pl, o, d):
        sc = jscene.replace(sphere_params=sph, box_params=box,
                            plane_params=pl)
        return jnp.sum(w * jrm.raymarch(sc, o, d, jp)[0])

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(getattr(jscene, k) for k in GEOMETRY), jnp.asarray(ro),
        jnp.asarray(rd))
    scene, leaves = _leaves(jscene, ro, rd)
    t, hit, _mat, _n = trm.march_gbuf(scene, leaves[3], leaves[4],
                                      RaymarchParams(**RM))
    assert 0.5 < float(hit.float().mean()) <= 1.0
    (torch.from_numpy(w) * t).sum().backward()
    _assert_grads(leaves, want, GEOMETRY + ("ro", "rd"))


@pytest.mark.parametrize("fused_normal", [False, True])
def test_t_and_normal_gradients_match_fused_pallas_adjoint(fused_normal):
    """d(Σ w_t·t + Σ w_n·n) with respect to the spheres, planes and rd by
    the port's ``march_gbuf``, its normal differentiated by autograd at the
    hit point, or by ``march(fused=True)`` (K7's form: the normal from the
    forward, its chain recomputed in the backward), against
    ``raymarch_pallas_gbuf(interpret=True)``'s ``_gbuf_fused_bwd``
    (``tests/test_raymarch.py::test_march_kernel_fused_normal_gradients``)."""
    jscene = _sphere_jscene(2)
    ro, rd = _rays()
    w_t, w_n = _weights(3, (H, W)), _weights(4, (3, H, W)) - 1.0
    jp = JRaymarchParams(**RM)

    def loss(sph, pl, d):
        sc = jscene.replace(sphere_params=sph, plane_params=pl)
        t, _hit, _mat, n = raymarch_pallas_gbuf(sc, jnp.asarray(ro), d, jp,
                                                True)
        return jnp.sum(w_t * t) + jnp.sum(w_n * n)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jscene.sphere_params, jscene.plane_params, jnp.asarray(rd))
    scene, leaves = _leaves(jscene, rd)
    march = (trm.march if fused_normal else trm.march_gbuf)
    kw = dict(fused=True) if fused_normal else {}
    t, hit, _mat, n = march(scene, torch.tensor(ro), leaves[3],
                            RaymarchParams(**RM), **kw)
    ((torch.from_numpy(w_t) * t).sum()
     + (torch.from_numpy(w_n) * n).sum()).backward()
    _assert_grads([leaves[0], leaves[2], leaves[3]], want,
                  ("sphere_params", "plane_params", "rd"))


def _zero_safe_norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm``'s 2-norm with derivative 0 at 0 (the double
    ``where``), the same value everywhere."""
    s = jnp.sum(x * x, axis=axis, keepdims=keepdims)
    pos = s > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)


@pytest.mark.parametrize("fused_normal", [False, True])
def test_normal_chain_at_box_hits_matches_jax_with_zero_safe_norm(
        fused_normal, monkeypatch):
    """d(Σ w_t·t + Σ w_n·n) on the Cornell box, boxes kept, with respect to
    its spheres, boxes, planes and rd, against
    ``raymarch_pallas_gbuf(interpret=True)``'s ``_gbuf_fused_bwd`` traced
    with a zero-safe norm (its own gives NaN at every box hit); the traces
    are cleared before and after, so no other test reuses them."""
    jscene = _jscene(2)
    ro, rd = _rays()
    w_t, w_n = _weights(3, (H, W)), _weights(4, (3, H, W)) - 1.0
    jp = JRaymarchParams(**RM)

    def loss(sph, box, pl, d):
        sc = jscene.replace(sphere_params=sph, box_params=box,
                            plane_params=pl)
        t, _hit, _mat, n = raymarch_pallas_gbuf(sc, jnp.asarray(ro), d, jp,
                                                True)
        return jnp.sum(w_t * t) + jnp.sum(w_n * n)

    monkeypatch.setattr(jnp.linalg, "norm", _zero_safe_norm)
    jax.clear_caches()
    try:
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(getattr(jscene, k) for k in GEOMETRY), jnp.asarray(rd))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    assert all(np.isfinite(np.asarray(w)).all() for w in want)
    scene, leaves = _leaves(jscene, rd)
    march = (trm.march if fused_normal else trm.march_gbuf)
    kw = dict(fused=True) if fused_normal else {}
    t, hit, _mat, n = march(scene, torch.tensor(ro), leaves[3],
                            RaymarchParams(**RM), **kw)
    ((torch.from_numpy(w_t) * t).sum()
     + (torch.from_numpy(w_n) * n).sum()).backward()
    _assert_grads(leaves, want, GEOMETRY + ("rd",))


def test_render_gbuffer_geometry_gradient_matches_jax():
    """d(Σ w·render + Σ depth + Σ w_m·motion) with respect to the scene's
    geometry through the port's ``render_gbuffer`` (the hit point's and
    the normal's cotangents from the shading into the march) against JAX's
    ``render_gbuffer(impl="jnp")``, the port given JAX's light sample."""
    jscene = _sphere_jscene(5)
    jcam, jprev = j_orbit(0.25), j_orbit(0.1875)
    key = jax.random.PRNGKey(7)
    w = _weights(6, (3, H, W))
    w_m = _weights(8, (2, H, W)) * 1e-3
    jcfg = JCameraParams(width=W, height=H)
    jp = JRaymarchParams(**RM)

    def loss(sph, pl):
        sc = jscene.replace(sphere_params=sph, plane_params=pl)
        g = jrm.render_gbuffer(sc, jcam, jprev, key, cam_cfg=jcfg, params=jp)
        return (jnp.sum(w * g.render) + jnp.sum(g.depth)
                + jnp.sum(w_m * g.motion))

    want = jax.grad(loss, argnums=(0, 1))(jscene.sphere_params,
                                          jscene.plane_params)
    lp = np.asarray(jrm.sample_light(jscene, jax.random.split(key, 1)[0],
                                     (H, W)))
    scene, leaves = _leaves(jscene)
    cam = convert.camera_from_numpy(convert.fields_to_numpy(jcam), "cpu")
    prev = convert.camera_from_numpy(convert.fields_to_numpy(jprev), "cpu")
    for impl in ("plain", "auto"):
        for x in leaves:
            x.grad = None
        g = trm.render_gbuffer(scene, cam, prev, cam_cfg=CameraParams(
            width=W, height=H), params=RaymarchParams(**RM),
            light_sample=torch.from_numpy(lp), impl=impl)
        ((torch.from_numpy(w) * g.render).sum() + g.depth.sum()
         + (torch.from_numpy(w_m) * g.motion).sum()).backward()
        _assert_grads([leaves[0], leaves[2]], want,
                      ("sphere_params", "plane_params"))


def _sphere_interior(scene, ro, rd, params):
    """Pixels on the sphere whose 8 neighbours are on it too."""
    with torch.no_grad():
        t, hit, mat, _n = trm.march_gbuf(scene, ro, rd, params)
    on = ((mat == 4) & hit).numpy()
    interior = on.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= np.roll(np.roll(on, dy, 0), dx, 1)
    assert interior.sum() > 20
    return torch.from_numpy(interior)


@pytest.mark.parametrize("index", [3, 2], ids=["radius", "centre_z"])
def test_implicit_adjoint_matches_finite_differences(index):
    """The sphere's radius and centre z: the adjoint's derivative of the
    masked hit distances against central differences of the march
    (``tests/test_raymarch.py``'s two checks)."""
    scene = trm.cornell_scene(device="cpu")
    cfg = CameraParams(width=64, height=64)
    params = RaymarchParams(**RM)
    ro, rd, _ = trm.camera_rays(trm.cornell_camera(device="cpu"), cfg)
    mask = _sphere_interior(scene, ro, rd, params)

    def loss_at(value, grad=False):
        sph = scene.sphere_params.clone()
        sph[0, index] = value
        sph.requires_grad_(grad)
        t, _hit = trm.raymarch(dataclasses.replace(scene, sphere_params=sph),
                               ro, rd, params)
        return torch.where(mask, t, torch.zeros_like(t)).sum(), sph

    v0 = float(scene.sphere_params[0, index])
    loss, sph = loss_at(v0, grad=True)
    loss.backward()
    g = float(sph.grad[0, index])
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss_at(v0 + eps)[0]) - float(loss_at(v0 - eps)[0])) / (
            2 * eps)
    if index == 3:
        assert g < 0     # a larger sphere shortens the masked rays
    np.testing.assert_allclose(g, fd, rtol=0.05)


@pytest.mark.parametrize("fused_normal", [False, True])
@pytest.mark.parametrize("index", [2, 5], ids=["centre_z", "half_z"])
def test_box_adjoint_with_normal_matches_finite_differences(index,
                                                           fused_normal):
    """The tall box's centre z and half-size z: the adjoint's derivative of
    Σ t + Σ w_n·n over the pixels inside the boxes' faces (the normal
    chain there, whose stencil points lie inside a box, included) against
    central differences of the march, rtol 0.05."""
    scene = trm.cornell_scene(device="cpu")
    cfg = CameraParams(width=64, height=64)
    params = RaymarchParams(**RM)
    ro, rd, _ = trm.camera_rays(trm.cornell_camera(device="cpu"), cfg)
    with torch.no_grad():
        _t, hit, mat, _n = trm.march_gbuf(scene, ro, rd, params)
    on = ((mat == int(scene.box_mat[0])) & hit).numpy()
    interior = on.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= np.roll(np.roll(on, dy, 0), dx, 1)
    assert interior.sum() > 200
    mask = torch.from_numpy(interior)
    w_n = torch.from_numpy(_weights(9, (3, 64, 64)) - 1.0) * mask
    march = (trm.march if fused_normal else trm.march_gbuf)
    kw = dict(fused=True) if fused_normal else {}

    def loss_at(value, grad=False):
        box = scene.box_params.clone()
        box[0, index] = value
        box.requires_grad_(grad)
        t, _hit, _mat, n = march(dataclasses.replace(scene, box_params=box),
                                 ro, rd, params, **kw)
        return torch.where(mask, t, torch.zeros_like(t)).sum() + (
            w_n * n).sum(), box

    v0 = float(scene.box_params[0, index])
    loss, box = loss_at(v0, grad=True)
    loss.backward()
    g = float(box.grad[0, index])
    assert np.isfinite(g) and abs(g) > 1.0
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss_at(v0 + eps)[0]) - float(loss_at(v0 - eps)[0])) / (
            2 * eps)
    np.testing.assert_allclose(g, fd, rtol=0.05)


def test_forward_unchanged_and_material_ids_carry_no_gradient():
    """The Function returns the plain march's floats, fused or not, and
    the hit mask and material ids are not differentiable."""
    scene = trm.cornell_scene(device="cpu")
    cfg = CameraParams(width=32, height=24)
    params = RaymarchParams(**RM)
    ro, rd, _ = trm.camera_rays(trm.cornell_camera(device="cpu"), cfg)
    rd = rd.clone().requires_grad_()
    a = trm.march_gbuf(scene, ro, rd, params)
    b = trm.march(scene, ro, rd, params, fused=True)
    with torch.no_grad():
        t0 = trm._raymarch_loop(scene, ro, rd, params)
    assert torch.equal(a[0], t0) and torch.equal(b[0], t0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].requires_grad and a[3].requires_grad and b[3].requires_grad
    assert not a[1].requires_grad and not a[2].requires_grad
