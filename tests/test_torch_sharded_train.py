"""Gradients, the pipeline and the train step of the port's sharded path
(``parallel/sharded.py``) on gloo process groups, against the JAX
package's single-device functions.

One group a mesh shape ((1, 2, 2); (1, 2, 4), where the deep sweep's
16-pixel halo exceeds the 8-pixel tiles: the multi-hop per-level path;
(2, 1, 2), a data axis whose two slices each render the frame) runs
every check (``tests/_torch_sharded_workers.py``):

* the sweep's gradients with respect to colour and variance, through the
  halo exchange's transpose and the kernels' margin-writing adjoints (the
  plain twins of K14 and K2), against ``jax.grad`` of
  ``svgf_spatial_ref(detach_weights=True)`` at rtol 1e-4, atol 1e-6
  (``tests/test_sharded.py:133-150``); the stored bf16 adjoint at atol
  1.5e-3·max (``tests/test_sharded.py:199``);
* the differentiable temporal step on the history canvas (K4c, K5c with
  the motion gradient, K6c without; the canvas carried from frame 1 to
  frame 2 with its margins exchanged): gradients with respect to frame
  1's render and frame 2's motion against ``jax.grad`` of two
  ``temporal_accumulate`` steps, atol 1e-5·max;
* the sharded pipeline (``make_sharded_pipeline``) over two orbit frames
  at 48x64 against ``render_and_denoise(impl="reference")`` with the JAX
  renderer's light samples: denoised, albedo and depth atol 1e-4·max
  outside the geometric tie pixels (``tests/test_torch_pipeline.py``);
* the sharded train step, two steps at 42x64 (no tie pixels in that
  frame), against ``make_train_step(impl="reference")``, as
  ``tests/test_torch_train.py`` holds the unsharded one: loss rtol 1e-5;
  albedo gradient atol 1e-4·max with the plain path, 3e-3·max with the
  kernels' (stored bf16 weights); updated albedo atol 1e-6 / 1e-5;
* the sharded pipeline with ``RaymarchParams(coarse_seed=True)`` (each
  rank seeds its tile from the camera at its window origin) against the
  unseeded one of the same group: a seeded march stops elsewhere in the
  hit_eps shell, so at most 0.5 % of the pixels flip their hit or material
  (grazing edges), and on the others the depth's 99th percentile of |Δ|
  is under 2·hit_eps and the denoised frame's under 2e-3·max, its largest
  under 1e-2·max.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raymarchdenoisercuda_tpu.config import (
    CameraParams as JCameraParams, RaymarchParams as JRaymarchParams,
    SVGFParams as JSVGFParams)
from raymarchdenoisercuda_tpu.gbuffer import (GBuffer as JGBuffer,
                                              History as JHistory)
from raymarchdenoisercuda_tpu.io.generate import orbit_camera as j_orbit
from raymarchdenoisercuda_tpu.models.pipeline import (
    init_train_state as j_init_train_state,
    make_train_step as j_make_train_step,
    render_and_denoise as j_render_and_denoise)
from raymarchdenoisercuda_tpu.ops.atrous import svgf_spatial_ref
from raymarchdenoisercuda_tpu.ops.temporal import temporal_accumulate
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)

from _torch_sharded_workers import run_group

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")

MESHES = [(1, 2, 2), (1, 2, 4), (2, 1, 2)]
GRADS = {
    # name: (SVGFParams kwargs, impl, bwd_impl, atol / max or None)
    "plain": (dict(iterations=2), "plain", "auto", None),
    "recompute": (dict(iterations=2), "auto", "recompute", None),
    "stored": (dict(iterations=2), "auto", "stored", 1.5e-3),
    "deep": (dict(iterations=4), "auto", "recompute", None),
}
G = 32
TT = 48
PIPE_H, PIPE_W = 48, 64
PIPES = (("plain", "plain"), ("auto", "auto"), ("auto", "fused"),
         ("auto", "ad"), ("auto", "ad_canvas"))
SEEDED_PIPES = (("auto", "auto"),)
TRAIN_H, TRAIN_W = 42, 64
RM = dict(max_steps=48, shadow_steps=24)
SV = dict(iterations=3, radius=1)


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return (rng.random((3, H, W), dtype=np.float32),
            (0.02 * rng.random((H, W))).astype(np.float32), n,
            (0.3 + 0.5 * rng.random((H, W))).astype(np.float32))


def _frames():
    c1, _, n, d = _planes(3, TT, TT)
    c2 = _planes(4, TT, TT)[0]
    out = []
    for seed, mag, c in ((3, 3.5, c1), (4, 3.9, c2)):
        m = ((2.0 * np.random.default_rng(seed).random((2, TT, TT)) - 1.0)
             * mag).astype(np.float32)
        out.append(dict(render=c, albedo=c, normal=n, depth=d, motion=m))
    return out


def _cam(jcam):
    return {k: np.asarray(getattr(jcam, k))
            for k in ("position", "look_at", "up")}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's answers to every check, computed once."""
    planes = _planes(5, G, G)
    grads = {}
    for k, (kw, _i, _b, _t) in GRADS.items():
        p = JSVGFParams(**kw)
        n, d = jnp.asarray(planes[2]), jnp.asarray(planes[3])

        def loss(c, v):
            oc, ov = svgf_spatial_ref(c, v, n, d, params=p,
                                      detach_weights=True)
            return jnp.sum(oc ** 2) + jnp.sum(ov)

        grads[k] = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(planes[0]), jnp.asarray(planes[1]))]

    frames = _frames()
    cot = np.random.default_rng(6).standard_normal(
        (3, TT, TT)).astype(np.float32)
    tparams = JSVGFParams(max_motion=4)

    def tloss(r1, m2):
        g1 = JGBuffer(**{k: jnp.asarray(v) for k, v in frames[0].items()})
        g2 = JGBuffer(**{k: jnp.asarray(v) for k, v in frames[1].items()})
        _, _, h = temporal_accumulate(g1.replace(render=r1),
                                      JHistory.zeros(TT, TT), params=tparams)
        integ, _, _ = temporal_accumulate(g2.replace(motion=m2), h,
                                          params=tparams)
        return jnp.sum(jnp.asarray(cot) * integ)

    tgrads = [np.asarray(g) for g in jax.grad(tloss, argnums=(0, 1))(
        jnp.asarray(frames[0]["render"]), jnp.asarray(frames[1]["motion"]))]

    jscene = jrm.cornell_scene()
    cfg = dict(cam_cfg=JCameraParams(width=PIPE_W, height=PIPE_H),
               rm_params=JRaymarchParams(**RM), svgf_params=JSVGFParams(**SV))
    key, hist, prev = jax.random.PRNGKey(0), JHistory.zeros(PIPE_H, PIPE_W), None
    pipe = []
    for f in range(2):
        key, sub = jax.random.split(key)
        cam = j_orbit(f / 16)
        out, hist = j_render_and_denoise(jscene, cam, prev, hist, sub,
                                         impl="reference", **cfg)
        light = np.asarray(jrm.sample_light(
            jscene, jax.random.split(sub, 1)[0], (PIPE_H, PIPE_W)))
        pipe.append(dict(cam=_cam(cam), light=light,
                         **{k: np.asarray(getattr(out, k))
                            for k in ("denoised", "albedo", "depth")}))
        prev = cam

    target = np.random.default_rng(0).random((3, TRAIN_H, TRAIN_W),
                                             dtype=np.float32)
    opt = optax.adam(1e-2)
    step = j_make_train_step(
        jscene, jrm.cornell_camera(), jnp.asarray(target), opt,
        cam_cfg=JCameraParams(width=TRAIN_W, height=TRAIN_H),
        rm_params=JRaymarchParams(**RM), svgf_params=JSVGFParams(**SV),
        impl="reference")
    state = j_init_train_state(jscene.materials.albedo, opt, TRAIN_H,
                               TRAIN_W, jax.random.PRNGKey(0))
    train, mu_prev = [], np.zeros((6, 3), np.float32)
    for _ in range(2):
        _, sub = jax.random.split(state.key)
        light = np.asarray(jrm.sample_light(
            jscene, jax.random.split(sub, 1)[0], (TRAIN_H, TRAIN_W)))
        state, loss = step(state)
        mu = np.asarray(state.opt_state[0].mu)
        train.append(dict(light=light, loss=float(loss),
                          grad=(mu - 0.9 * mu_prev) / 0.1,
                          albedo=np.asarray(state.albedo)))
        mu_prev = mu
    return dict(planes=planes, grads=grads, frames=frames, cot=cot,
                tgrads=tgrads, scene=convert.fields_to_numpy(jscene),
                cam=_cam(jrm.cornell_camera()), pipe=pipe, target=target,
                train=train)


def _grow(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_gradients_pipeline_and_train_step_match_jax(
        tmp_path, mesh_shape, jax_run):
    j = jax_run
    pipe_cfg = dict(cam_cfg=CameraParams(width=PIPE_W, height=PIPE_H),
                    rm_params=RaymarchParams(**RM),
                    svgf_params=SVGFParams(**SV))
    train_cfg = dict(cam_cfg=CameraParams(width=TRAIN_W, height=TRAIN_H),
                     rm_params=RaymarchParams(**RM),
                     svgf_params=SVGFParams(**SV))
    jobs = dict(
        grad=("sweep_grad_worker", dict(cases={
            k: (j["planes"], SVGFParams(**kw), impl, bwd)
            for k, (kw, impl, bwd, _t) in GRADS.items()})),
        tgrad=("temporal_grad_worker", dict(
            frames=j["frames"], params=SVGFParams(max_motion=4),
            cot=j["cot"])),
        tgrad_hist=("temporal_grad_worker", dict(
            frames=j["frames"], params=SVGFParams(max_motion=4),
            cot=j["cot"], motion_grad=False)),
        pipe=("pipeline_worker", dict(
            scene_np=j["scene"], cams=[f["cam"] for f in j["pipe"]],
            lights=[f["light"] for f in j["pipe"]], impls=PIPES,
            **pipe_cfg)),
        pipe_seeded=("pipeline_worker", dict(
            scene_np=j["scene"], cams=[f["cam"] for f in j["pipe"]],
            lights=[f["light"] for f in j["pipe"]], impls=SEEDED_PIPES,
            **dict(pipe_cfg, rm_params=RaymarchParams(coarse_seed=True,
                                                      **RM)))),
        **{f"train_{impl}": ("train_worker", dict(
            scene_np=j["scene"], cam=j["cam"], target=j["target"],
            lights=[s["light"] for s in j["train"]], impl=impl,
            **train_cfg)) for impl in ("plain", "auto")})
    res = run_group(tmp_path, mesh_shape, "multi_worker", jobs=jobs)[0]

    for k, (_kw, _i, _b, tol) in GRADS.items():
        for name, want in zip(("dcolor", "dvariance"), j["grads"][k]):
            got = res[f"grad/{k}_{name}"]
            if tol is None:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{k} {name}")
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=tol * np.abs(want).max(),
                    err_msg=f"{k} {name}")
    for name, want in zip(("d_render", "d_motion"), j["tgrads"]):
        np.testing.assert_allclose(res[f"tgrad/{name}"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(res["tgrad_hist/d_render"], j["tgrads"][0],
                               rtol=0, atol=1e-5 * np.abs(j["tgrads"][0]).max(),
                               err_msg="d_render without the motion gradient")

    for impl, temporal in PIPES:
        tainted = np.zeros((PIPE_H, PIPE_W), bool)
        for f, want in enumerate(j["pipe"]):
            got = {n: res[f"pipe/{impl}_{temporal}_{n}{f}"]
                   for n in ("denoised", "albedo", "depth")}
            ties = ((np.abs(got["albedo"] - want["albedo"]).max(0) > 1e-4)
                    | (np.abs(got["depth"] - want["depth"]) > 1e-4))
            assert ties.mean() <= 2e-3, (impl, temporal, f, int(ties.sum()))
            tainted |= _grow(ties, 2)
            keep = ~tainted
            for n in ("denoised", "albedo", "depth"):
                np.testing.assert_allclose(
                    got[n][..., keep], want[n][..., keep], rtol=0,
                    atol=1e-4 * np.abs(want[n]).max(),
                    err_msg=f"{impl}/{temporal} frame {f} {n}")

    hit_eps = RaymarchParams().hit_eps
    for impl, temporal in SEEDED_PIPES:
        for f in range(len(j["pipe"])):
            key = f"{impl}_{temporal}_{{}}{f}"
            a = {n: res["pipe_seeded/" + key.format(n)]
                 for n in ("denoised", "albedo", "depth")}
            b = {n: res["pipe/" + key.format(n)]
                 for n in ("denoised", "albedo", "depth")}
            same = ((a["albedo"] == b["albedo"]).all(0)
                    & ((a["depth"] > 0) == (b["depth"] > 0)))
            assert same.mean() >= 0.995, (f, int((~same).sum()))
            dz = np.abs(a["depth"] - b["depth"])[same]
            assert np.percentile(dz, 99) < 2 * hit_eps, f
            dd = np.abs(a["denoised"] - b["denoised"]).max(0)[same]
            scale = np.abs(b["denoised"]).max()
            assert np.percentile(dd, 99) < 2e-3 * scale, f
            assert dd.max() < 1e-2 * scale, f

    for impl, tol, albedo_atol in (("plain", 1e-4, 1e-6),
                                   ("auto", 3e-3, 1e-5)):
        for k, want in enumerate(j["train"]):
            loss = float(res[f"train_{impl}/loss{k}"])
            assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"]), (
                impl, k, loss, want["loss"])
            np.testing.assert_allclose(res[f"train_{impl}/grad{k}"],
                                       want["grad"], rtol=0,
                                       atol=tol * np.abs(want["grad"]).max())
            np.testing.assert_allclose(res[f"train_{impl}/albedo{k}"],
                                       want["albedo"], rtol=0,
                                       atol=albedo_atol)
