"""The training step (BASELINE config 4) of the port against the JAX
package's ``make_train_step(impl="reference")``, cut to 45x60 with
3 à-trous levels at radius 1 and 48/24 march/shadow steps.

Both run two steps from the scene's albedo table with the same light
samples (the port is handed the ones the JAX step draws: torch cannot
reproduce threefry).  45x60 has no exact floor/wall tie pixel in the
Cornell camera's frame (48x64 has three, see
``tests/test_torch_pipeline.py``), so every pixel is compared.  The
albedo gradient is read from optax's first moment (``mu = 0.1·g`` after
one step, ``g2 = (mu2 − 0.9·mu1)/0.1`` after two).

Tolerances:
* the plain path (``impl="plain"``: autograd through the f32 oracle
  weights, the JAX package's own semantics): loss rtol 1e-5, gradient and
  Adam moments atol 1e-4·max|ref|, updated albedo atol 1e-6 (Adam's
  ``m̂/(√v̂+ε)`` and PyTorch's ``lr/bc1·m/(√v/√bc2+ε)`` round differently);
* the kernel path's algorithm (``impl="auto"`` on CPU tensors: the plain
  twins of K1-K8, with the stored bf16 tap weights in the adjoint): loss
  rtol 1e-5 (the forward is the same), gradient and moments atol
  3e-3·max|ref| (the JAX package's stored-bf16 bound), albedo atol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raymarchdenoisercuda_tpu.config import (
    CameraParams as JCameraParams, RaymarchParams as JRaymarchParams,
    SVGFParams as JSVGFParams)
from raymarchdenoisercuda_tpu.models.pipeline import (
    init_train_state as j_init_train_state,
    make_train_step as j_make_train_step)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.models.pipeline import (
    init_train_state, make_train_step)
from raymarchdenoisercuda_torch.ops import raymarch as trm

jrm = importlib.import_module("raymarchdenoisercuda_tpu.ops.raymarch")

H, W = 45, 60
RM = dict(max_steps=48, shadow_steps=24)
SV = dict(iterations=3, radius=1)
STEPS = 2


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps: per step the light sample, loss, albedo gradient,
    optax's moments and the state after it."""
    scene = jrm.cornell_scene()
    target = np.random.default_rng(0).random((3, H, W), dtype=np.float32)
    opt = optax.adam(1e-2)
    step = j_make_train_step(
        scene, jrm.cornell_camera(), jnp.asarray(target), opt,
        cam_cfg=JCameraParams(width=W, height=H),
        rm_params=JRaymarchParams(**RM), svgf_params=JSVGFParams(**SV),
        impl="reference")
    state = j_init_train_state(scene.materials.albedo, opt, H, W,
                               jax.random.PRNGKey(0))
    steps, mu_prev = [], np.zeros((6, 3), np.float32)
    for _ in range(STEPS):
        _, sub = jax.random.split(state.key)
        lp = np.asarray(jrm.sample_light(scene, jax.random.split(sub, 1)[0],
                                         (H, W)))
        state, loss = step(state)
        adam = state.opt_state[0]
        mu, nu = np.asarray(adam.mu), np.asarray(adam.nu)
        steps.append(dict(light=np.array(lp), loss=float(loss),
                          grad=(mu - 0.9 * mu_prev) / 0.1, mu=mu, nu=nu,
                          state=state, albedo=np.asarray(state.albedo)))
        mu_prev = mu
    return scene, target, steps


def _port_step(jscene, target, impl):
    scene = convert.scene_from_numpy(convert.fields_to_numpy(jscene), "cpu")
    return scene, make_train_step(
        scene, trm.cornell_camera(device="cpu"), torch.from_numpy(target),
        cam_cfg=CameraParams(width=W, height=H),
        rm_params=RaymarchParams(**RM), svgf_params=SVGFParams(**SV),
        impl=impl)


def _compare(state, loss, want, tol, albedo_atol):
    assert abs(float(loss) - want["loss"]) <= 1e-5 * abs(want["loss"])
    adam = state.optimizer.state[state.albedo]
    for name, got, ref in (("grad", state.albedo.grad, want["grad"]),
                           ("mu", adam["exp_avg"], want["mu"]),
                           ("nu", adam["exp_avg_sq"], want["nu"])):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(state.albedo.detach().numpy(),
                               want["albedo"], rtol=0, atol=albedo_atol)


@pytest.mark.parametrize("impl,tol,albedo_atol", [("plain", 1e-4, 1e-6),
                                                  ("auto", 3e-3, 1e-5)])
def test_two_train_steps_match_jax(jax_run, impl, tol, albedo_atol):
    jscene, target, steps = jax_run
    scene, step = _port_step(jscene, target, impl)
    state = init_train_state(scene.materials.albedo, H, W)
    for k, want in enumerate(steps):
        state, loss = step(state,
                           light_sample=torch.from_numpy(want["light"]))
        _compare(state, loss, want, tol, albedo_atol)
        assert not state.history.color.requires_grad    # detached
        assert float(state.history.length.max()) == k + 1
    albedo = state.albedo.detach()
    assert 0.0 <= float(albedo.min()) and float(albedo.max()) <= 1.0


def test_state_carried_from_jax_continues_the_run(jax_run):
    """One JAX step, ``convert``, then one port step equals two JAX steps;
    the state goes back to numpy with optax's names."""
    jscene, target, steps = jax_run
    first = steps[0]["state"]
    state = convert.train_state_from_numpy(
        first.albedo, dict(count=first.opt_state[0].count,
                           mu=first.opt_state[0].mu,
                           nu=first.opt_state[0].nu),
        convert.fields_to_numpy(first.history), "cpu")
    _, step = _port_step(jscene, target, "plain")
    state, loss = step(state, light_sample=torch.from_numpy(
        steps[1]["light"]))
    _compare(state, loss, steps[1], 1e-4, 1e-6)
    back = convert.train_state_to_numpy(state)
    assert int(back["adam"]["count"]) == 2
    np.testing.assert_array_equal(back["albedo"],
                                  state.albedo.detach().numpy())
    assert back["history"]["length"].max() == 2.0
