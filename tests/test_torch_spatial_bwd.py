"""Gradients of the port's à-trous sweep against the JAX package.

* The plain sweep (``ops.atrous.svgf_spatial_ref``, autograd) against
  ``jax.grad`` of the JAX ``svgf_spatial_ref`` with the same
  ``detach_weights``: rtol 1e-4 for one level, 2e-4 for the multi-level
  sweep (the VJP tolerances of ROADMAP.md), atol 1e-6·scale for entries that
  cancel to near zero.  Before ``detach_weights`` existed the port
  differentiated through the weights, which is the ``False`` case.
* The stored-weight sweep (``svgf_spatial_stored_cuda`` on CPU tensors: the
  plain twins of K1 in store mode and K2) against the JAX oracle's detached
  gradients: atol 3e-3·scale, where scale is max|oracle gradient| — the
  JAX package's stored-bf16 bound (``tests/test_atrous_pallas.py``); the
  adjoint multiplies bf16-rounded weights (2^-8 relative each) while the
  forward's values and N use the float weights, which are the oracle's.
* The stored sweep with fast weights (no jnp oracle) against
  ``svgf_spatial_pallas(interpret=True, bwd_impl="stored",
  weight_math="fast")``: values at the forward's fast-weight bound
  atol 2e-4·max; gradients at atol 5e-4·scale (measured 1.3e-4 here) —
  the kernel's Newton reciprocals move a fast weight by up to 1.4e-4
  relative, which can flip the bf16 rounding of that weight (one 2^-8
  step) on either side.  Radius 1, the adopted mode, only: interpret mode
  is slow, and the radius-2 fast forward is held to the kernel in
  ``tests/test_torch_spatial.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.ops.atrous import (
    svgf_spatial_ref as j_svgf_spatial_ref)
from raymarchdenoisercuda_tpu.ops.pallas.atrous_tpu import svgf_spatial_pallas
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.ops import atrous
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    svgf_spatial_cuda, svgf_spatial_stored_cuda)

H, W = 24, 32


def _planes(seed, H=H, W=W):
    rng = np.random.default_rng(seed)
    color = rng.random((3, H, W), dtype=np.float32)
    variance = (0.02 * rng.random((H, W))).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    # loss weights: sum(wc·c) + sum(wv·v) + sum(wf·feedback)
    cots = (rng.standard_normal((3, H, W)).astype(np.float32),
            rng.standard_normal((H, W)).astype(np.float32),
            rng.standard_normal((3, H, W)).astype(np.float32))
    return (color, variance, n, depth), cots


def _jax_grads(planes, cots, params, detach_weights):
    normal, depth = planes[2], planes[3]

    def loss(c, v):
        oc, ov, fb = j_svgf_spatial_ref(c, v, normal, depth, params=params,
                                        detach_weights=detach_weights,
                                        return_feedback=True)
        return (jnp.sum(oc * cots[0]) + jnp.sum(ov * cots[1])
                + jnp.sum(fb * cots[2]))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        *map(jnp.asarray, planes[:2]))]


def _torch_grads(fn, planes, cots, **kw):
    c, v = (torch.from_numpy(x).requires_grad_() for x in planes[:2])
    normal, depth = (torch.from_numpy(x) for x in planes[2:])
    oc, ov, fb = fn(c, v, normal, depth, return_feedback=True, **kw)
    wc, wv, wf = (torch.from_numpy(x) for x in cots)
    ((oc * wc).sum() + (ov * wv).sum() + (fb * wf).sum()).backward()
    return [c.grad.numpy(), v.grad.numpy()], (oc, ov, fb)


def _close(got, want, *, rtol=0.0, scale_atol):
    for name, a, b in zip(("d_color", "d_variance"), got, want):
        scale = np.abs(b).max()
        assert scale > 0, f"{name} trivially zero"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=scale_atol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("iterations,rtol,detach_weights", [
    (1, 1e-4, True), (1, 1e-4, False), (3, 2e-4, True)])
def test_plain_sweep_gradient_matches_jax(iterations, rtol, detach_weights):
    planes, cots = _planes(1)
    kw = dict(iterations=iterations, radius=2, feedback_level=1)
    want = _jax_grads(planes, cots, JSVGFParams(**kw), detach_weights)
    got, _ = _torch_grads(atrous.svgf_spatial_ref, planes, cots,
                          params=SVGFParams(**kw),
                          detach_weights=detach_weights)
    _close(got, want, rtol=rtol, scale_atol=1e-6)


@pytest.mark.parametrize("radius,feedback_level", [(1, 1), (2, 0), (1, 7)])
def test_stored_sweep_gradient_matches_jax_oracle(radius, feedback_level):
    """feedback_level 0 feeds the input back and 7 (> iterations) is
    unused: both add the feedback cotangent to d_color at the end."""
    planes, cots = _planes(2 + radius)
    kw = dict(iterations=3, radius=radius, feedback_level=feedback_level)
    want = _jax_grads(planes, cots, JSVGFParams(**kw), True)
    got, outs = _torch_grads(svgf_spatial_stored_cuda, planes, cots,
                             params=SVGFParams(**kw))
    _close(got, want, scale_atol=3e-3)
    # the store mode leaves the forward's values as inference computes them
    ref = svgf_spatial_cuda(*map(torch.from_numpy, planes),
                            params=SVGFParams(**kw), return_feedback=True)
    for a, b in zip(outs, ref):
        assert torch.equal(a.detach(), b)


def test_stored_sweep_fast_weights_match_pallas_kernel():
    # interpret mode is slow: a smaller frame than the other tests
    planes, cots = _planes(11, 16, 40)
    kw = dict(iterations=2, radius=1, feedback_level=1)

    def loss(c, v):
        oc, ov, fb = svgf_spatial_pallas(
            c, v, *map(jnp.asarray, planes[2:]), params=JSVGFParams(**kw),
            interpret=True, weight_math="fast", bwd_impl="stored",
            return_feedback=True)
        return (jnp.sum(oc * cots[0]) + jnp.sum(ov * cots[1])
                + jnp.sum(fb * cots[2])), (oc, ov, fb)

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        *map(jnp.asarray, planes[:2]))
    got, outs = _torch_grads(svgf_spatial_stored_cuda, planes, cots,
                             params=SVGFParams(**kw), weight_math="fast")
    for a, b in zip(outs, want_out):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=2e-4 * np.abs(b).max())
    _close(got, [np.asarray(g) for g in want], scale_atol=5e-4)


def test_level_returns_weights_and_norm():
    """``return_weights``: tap weights (zero for out-of-image taps) whose
    sum is N, and the values they give."""
    planes, _ = _planes(5, 12, 16)
    c, v, w, norm = atrous.atrous_level_ref(
        *map(torch.from_numpy, planes), level=2,
        params=SVGFParams(radius=1), return_weights=True)
    assert w.shape == (9, 12, 16) and w.dtype == torch.float32
    assert float(w[0, :4].abs().max()) == 0.0     # tap (-4, -4): rows 0-3
    np.testing.assert_allclose(w.sum(0).numpy(), norm.numpy(), rtol=1e-6)
    c0, v0 = atrous.atrous_level_ref(*map(torch.from_numpy, planes),
                                     level=2, params=SVGFParams(radius=1))
    assert torch.equal(c, c0) and torch.equal(v, v0)


def test_inference_sweep_refuses_gradients():
    planes, _ = _planes(6, 8, 8)
    c, v, n, z = map(torch.from_numpy, planes)
    with pytest.raises(RuntimeError, match="no backward"):
        svgf_spatial_cuda(c.requires_grad_(), v, n, z)
    with torch.no_grad():
        svgf_spatial_cuda(c, v, n, z)
