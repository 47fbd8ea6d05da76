"""The à-trous sweep's adjoints in the port against the JAX package: the
plain twins of K1b, K2b, K14 and K9 (``ops/atrous.py``) and the sweep of
``svgf_spatial_ad_cuda`` on CPU tensors in every adjoint mode.

Tolerances (each relative to the compared plane's own max|·|, "·max"):

* Level forward with a given σ-denominator (K1b's twin) against
  ``atrous_level_fwd_pallas(interpret=True, save_weights=True)``: c and N
  at rtol 2e-5, atol 2e-6·max (as ``tests/test_atrous_pallas.py`` holds
  the kernel to its oracle); v at rtol 4e-5, atol 2e-7·max, twice c's
  rtol because the weights enter it squared; the weights as c.  The TPU kernel's degree-6 exp, squaring pow and Newton
  reciprocals against exp and pow: measured 1.9e-5 (c), 3.0e-5 (v)
  relative.
* K14's twin against ``atrous_level_bwd_pallas(interpret=True)`` and
  K2b's (float32 weights) against ``atrous_level_bwd_stored_pallas``: rtol
  1e-4, atol 1e-5·max for entries that cancel (measured 2.5e-5·max for
  K14, the TPU weight math; 1e-7 for K2b, the same weights).
* K9's twin against ``atrous_level_wgrad_bwd_pallas(interpret=True)``, all
  six outputs: atol 1e-4·max (measured ≤ 2.5e-5·max, the TPU weight math).
* K9's twin against float64 autograd of ``atrous_level_ref(
  detach_weights=False)`` with ∇z and σ as inputs: in float64, atol
  1e-12·max (the same algebra; measured ≤ 1.2e-14); in float32, atol
  5e-5·max (measured ≤ 1.1e-5: float32 rounding of the terms).
* ``weight_grads=True`` sweep against ``jax.grad`` of JAX's
  ``svgf_spatial_ref(detach_weights=False)``: d_color and d_variance atol
  1e-4·max, d_normal 5e-4·max (the JAX package's own bounds).  d_depth
  not against that f32 oracle, whose d = 0 tap forms ~1e7 cancelling terms
  (JAX holds it at 0.15): against float64 autograd of the port's plain
  sweep instead, at atol 1e-4·max, like d_color.  The level's d_depth,
  d_zgrad and d_sigma are held against the interpret-mode kernel above.
* ``recompute``, ``stored_f32`` and ``chained=False`` against the detached
  oracle's ``jax.grad``: atol 2e-4·max (the JAX package's stored_f32 vs
  recompute bound); ``chained=False`` is bit-equal to ``chained=True`` in
  recompute mode.
* ``svgf_denoise_frame(temporal="ad", spatial_bwd=m)`` against the plain
  path's autograd: atol 2e-4·max for ``stored_f32`` and ``recompute``,
  3e-3·max for ``stored`` (bf16 weights, as the training tests).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.ops.atrous import (
    svgf_spatial_ref as j_svgf_spatial_ref)
from raymarchdenoisercuda_tpu.ops.pallas.atrous_tpu import (
    atrous_level_bwd_pallas, atrous_level_bwd_stored_pallas,
    atrous_level_fwd_pallas, atrous_level_wgrad_bwd_pallas)
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import atrous
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level, atrous_level_bwd_cuda, atrous_level_bwd_stored_cuda,
    atrous_level_bwd_stored_f32_cuda, atrous_level_fwd_cuda,
    atrous_level_wgrad_bwd_cuda, svgf_spatial_ad_cuda)
from raymarchdenoisercuda_torch.ops.common import finite_diff_gradients

H, W = 24, 40
WGRAD_NAMES = ("d_color", "d_variance", "d_normal", "d_depth", "d_zgrad",
               "d_sigma_denom")


def _planes(seed, H=H, W=W):
    """color, variance, normal, depth, and cotangents gc, gv, gf."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return (rng.random((3, H, W), dtype=np.float32),
            (0.02 * rng.random((H, W))).astype(np.float32), n,
            (0.3 + 0.5 * rng.random((H, W))).astype(np.float32),
            rng.standard_normal((3, H, W)).astype(np.float32),
            rng.standard_normal((H, W)).astype(np.float32),
            rng.standard_normal((3, H, W)).astype(np.float32))


def _level_inputs(seed, radius, dtype=torch.float32):
    """Torch inputs of one level: c, v, n, z, ∇z, σ, gc, gv."""
    c, v, n, z, gc, gv, _ = (torch.from_numpy(a).to(dtype)
                             for a in _planes(seed))
    zg = finite_diff_gradients(z)
    sd = atrous.sigma_denominator(v, SVGFParams(radius=radius))
    return c, v, n, z, zg, sd, gc, gv


def _j(*tensors):
    return [jnp.asarray(t.numpy()) for t in tensors]


def _close(got, want, *, rtol=0.0, atol_max, names=None):
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        assert scale > 0, "trivially zero"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_max * scale,
                                   err_msg=names[k] if names else str(k))


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("level", [0, 2])
def test_level_fwd_with_sigma_matches_pallas(radius, level):
    c, v, n, z, zg, sd, _, _ = _level_inputs(radius, radius)
    jc, jv, jn, jw = atrous_level_fwd_pallas(
        *_j(c, v, n, z, zg, sd), level=level,
        params=JSVGFParams(radius=radius), interpret=True, save_weights=True)
    # K1b's wrapper on CPU tensors: the twin, float32 weights
    pc, pv, pn, pw = atrous_level_fwd_cuda(
        c, v, n, z, zg, sd, level=level, params=SVGFParams(radius=radius),
        save_weights=True)
    assert pw.dtype == torch.float32
    _close([pc, pn], [jc, jn], rtol=2e-5, atol_max=2e-6)
    _close([pv], [jv], rtol=4e-5, atol_max=2e-7)
    _close([pw], [jw], rtol=2e-5, atol_max=2e-6)


def test_level_sigma_denom_is_what_the_level_derives():
    """``sigma_denom=sigma_denominator(v)`` gives the fused level's values
    exactly; another σ gives other values."""
    c, v, n, z, zg, sd, _, _ = _level_inputs(3, 2)
    p = SVGFParams()
    fused = atrous.atrous_level_ref(c, v, n, z, zg, level=1, params=p)
    given = atrous.atrous_level_ref(c, v, n, z, zg, level=1, params=p,
                                    sigma_denom=sd)
    other = atrous.atrous_level_ref(c, v, n, z, zg, level=1, params=p,
                                    sigma_denom=2.0 * sd)
    for a, b, o in zip(fused, given, other):
        assert torch.equal(a, b) and not torch.equal(a, o)


@pytest.mark.parametrize("radius", [1, 2])
def test_recompute_and_stored_f32_adjoints_match_pallas(radius):
    c, v, n, z, zg, sd, gc, gv = _level_inputs(10 + radius, radius)
    p = SVGFParams(radius=radius)
    _, _, norm, w = atrous_level_fwd_cuda(c, v, n, z, zg, sd, level=1,
                                          params=p, save_weights=True)
    want = atrous_level_bwd_pallas(*_j(c, n, z, zg, sd, norm, gc, gv),
                                   level=1, params=JSVGFParams(radius=radius),
                                   interpret=True)
    got = atrous_level_bwd_cuda(c, n, z, zg, sd, norm, gc, gv, level=1,
                                params=p)
    _close(got, want, rtol=1e-4, atol_max=1e-5, names=("dc", "dv"))
    want = atrous_level_bwd_stored_pallas(
        *_j(w, norm, gc, gv), level=1, params=JSVGFParams(radius=radius),
        interpret=True)
    got = atrous_level_bwd_stored_f32_cuda(w, norm, gc, gv, level=1,
                                           radius=radius)
    _close(got, want, rtol=1e-4, atol_max=1e-5, names=("dc", "dv"))
    # the recompute twin is the stored twin on the forward's own weights
    for a, b in zip(atrous_level_bwd_stored_cuda(w, norm, gc, gv, level=1,
                                                 radius=radius),
                    atrous_level_bwd_cuda(c, n, z, zg, sd, norm, gc, gv,
                                          level=1, params=p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("radius", [1, 2])
def test_wgrad_adjoint_matches_pallas(radius):
    c, v, n, z, zg, sd, gc, gv = _level_inputs(20 + radius, radius)
    p = SVGFParams(radius=radius)
    oc, ov, norm = atrous_level_fwd_cuda(c, v, n, z, zg, sd, level=1,
                                         params=p)
    want = atrous_level_wgrad_bwd_pallas(
        *_j(c, v, n, z, zg, sd, oc, ov, norm, gc, gv), level=1,
        params=JSVGFParams(radius=radius), interpret=True)
    got = atrous_level_wgrad_bwd_cuda(c, v, n, z, zg, sd, oc, ov, norm, gc,
                                      gv, level=1, params=p)
    _close(got, want, atol_max=1e-4, names=WGRAD_NAMES)


def _autograd_level(ins, gc, gv, level, p):
    """Autograd of the plain level through its weights, with ∇z and σ as
    inputs: the gradients of sum(gc·c) + sum(gv·v) w.r.t. c, v, n, z, ∇z,
    σ."""
    ins = [t.clone().requires_grad_() for t in ins]
    c, v, n, z, zg, sd = ins
    oc, ov = atrous.atrous_level_ref(c, v, n, z, zg, level=level, params=p,
                                     detach_weights=False, sigma_denom=sd)
    return torch.autograd.grad((oc * gc).sum() + (ov * gv).sum(), ins)


@pytest.mark.parametrize("radius,level", [(1, 0), (1, 2), (2, 1)])
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12),
                                        (torch.float32, 5e-5)])
def test_wgrad_twin_matches_float64_autograd(radius, level, dtype, atol):
    ins64 = _level_inputs(30 + radius, radius, torch.float64)
    p = SVGFParams(radius=radius)
    want = _autograd_level(ins64[:6], *ins64[6:], level, p)
    c, v, n, z, zg, sd, gc, gv = (t.to(dtype) for t in ins64)
    oc, ov, _, norm = atrous.atrous_level_ref(c, v, n, z, zg, level=level,
                                              params=p, sigma_denom=sd,
                                              return_weights=True)
    got = atrous.atrous_level_wgrad_bwd_ref(c, v, n, z, zg, sd, oc, ov, norm,
                                            gc, gv, level=level, params=p)
    _close([g.double() for g in got], want, atol_max=atol,
           names=WGRAD_NAMES)


@functools.lru_cache(maxsize=None)
def _jax_sweep_grads(seed, radius, iterations, detach_weights):
    """``jax.grad`` of sum(wc·c) + sum(wv·v) + sum(wf·feedback) of JAX's
    ``svgf_spatial_ref`` w.r.t. colour, variance, normal and depth."""
    c, v, n, z, wc, wv, wf = _planes(seed)
    params = JSVGFParams(radius=radius, iterations=iterations)

    def loss(c, v, n, z):
        oc, ov, fb = j_svgf_spatial_ref(c, v, n, z, params=params,
                                        detach_weights=detach_weights,
                                        return_feedback=True)
        return jnp.sum(oc * wc) + jnp.sum(ov * wv) + jnp.sum(fb * wf)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (c, v, n, z)))]


def _torch_sweep_grads(fn, seed, dtype=torch.float32, **kw):
    c, v, n, z, wc, wv, wf = (torch.from_numpy(a).to(dtype)
                              for a in _planes(seed))
    ins = [t.requires_grad_() for t in (c, v, n, z)]
    oc, ov, fb = fn(*ins, return_feedback=True, **kw)
    loss = (oc * wc).sum() + (ov * wv).sum() + (fb * wf).sum()
    return [None if g is None else g.detach()
            for g in torch.autograd.grad(loss, ins, allow_unused=True)]


def test_weight_grads_sweep_matches_jax_oracle():
    params = SVGFParams(radius=1, iterations=2)
    want = _jax_sweep_grads(40, 1, 2, False)
    got = _torch_sweep_grads(svgf_spatial_ad_cuda, 40, params=params,
                             weight_grads=True)
    _close(got[:2], want[:2], atol_max=1e-4, names=("d_color", "d_variance"))
    _close(got[2:3], want[2:3], atol_max=5e-4, names=("d_normal",))
    # d_depth: against float64 autograd of the port's plain sweep
    want64 = _torch_sweep_grads(atrous.svgf_spatial_ref, 40, torch.float64,
                                params=params, detach_weights=False)
    _close(got, want64, atol_max=1e-4,
           names=("d_color", "d_variance", "d_normal", "d_depth"))


def test_weight_grads_change_the_gradients():
    """The weight-gradient terms are live: the full adjoint differs from
    the detached one in d_color, and reaches the normal and depth."""
    params = SVGFParams(radius=1, iterations=2)
    full = _torch_sweep_grads(svgf_spatial_ad_cuda, 41, params=params,
                              weight_grads=True)
    det = _torch_sweep_grads(svgf_spatial_ad_cuda, 41, params=params,
                             bwd_impl="recompute")
    assert float((full[0] - det[0]).abs().max()) > 1e-3 * float(
        det[0].abs().max())
    assert float(full[2].abs().max()) > 0 and float(full[3].abs().max()) > 0
    assert float(det[2].abs().max()) == 0 and float(det[3].abs().max()) == 0


@pytest.mark.parametrize("mode", [dict(bwd_impl="recompute"),
                                  dict(bwd_impl="stored_f32"),
                                  dict(chained=False),
                                  dict(chained=False, bwd_impl="none")])
def test_detached_modes_match_jax_oracle(mode):
    """``chained=False`` recomputes whatever ``bwd_impl`` says, as in
    JAX."""
    params = SVGFParams(radius=2, iterations=3)
    want = _jax_sweep_grads(42, 2, 3, True)
    got = _torch_sweep_grads(svgf_spatial_ad_cuda, 42, params=params,
                             **mode)
    _close(got[:2], want[:2], atol_max=2e-4, names=("d_color", "d_variance"))


def test_unchained_is_bit_equal_to_chained_recompute():
    params = SVGFParams(radius=1, iterations=3, feedback_level=2)
    a = _torch_sweep_grads(svgf_spatial_ad_cuda, 43, params=params,
                           bwd_impl="recompute")
    b = _torch_sweep_grads(svgf_spatial_ad_cuda, 43, params=params,
                           chained=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_recompute_level_gives_zero_guidance_gradients():
    """With K14, the level returns zeros for the normal, depth, ∇z and σ,
    as the JAX custom VJP does."""
    ins = [t.requires_grad_() for t in _level_inputs(44, 1)[:6]]
    c, v = atrous_level(*ins, 1, SVGFParams(radius=1))
    (c.sum() + v.sum()).backward()
    for t in ins[2:]:
        assert t.grad is not None and float(t.grad.abs().max()) == 0.0
    assert float(ins[0].grad.abs().max()) > 0


@pytest.mark.parametrize("kw,err,match", [
    (dict(bwd_impl="fused"), ValueError, "bwd_impl"),
    (dict(weight_math="approx"), ValueError, "weight_math"),
    (dict(weight_math="fast", bwd_impl="recompute"), ValueError,
     "stored bwd_impl"),
    (dict(weight_math="fast", weight_grads=True), ValueError, "chained"),
    (dict(weight_math="fast", chained=False), ValueError, "chained"),
    (dict(params=SVGFParams(luma_only_from=3), bwd_impl="recompute"),
     ValueError, "luma_only_from"),
    (dict(params=SVGFParams(luma_only_from=3), chained=False), ValueError,
     "luma_only_from"),
    (dict(params=SVGFParams(luma_only_from=3), weight_grads=True),
     ValueError, "luma_only_from"),
    (dict(params=SVGFParams(pyramid_from=2)), NotImplementedError,
     "pyramid_from"),
    (dict(precision="bf16", weight_math="fast"), ValueError, "chained"),
    (dict(precision="f16"), ValueError, "precision"),
])
def test_sweep_validation_raises(kw, err, match):
    c, v, n, z = (torch.from_numpy(a) for a in _planes(45, 8, 8)[:4])
    with pytest.raises(err, match=match):
        svgf_spatial_ad_cuda(c, v, n, z, **kw)


def test_sweep_accepts_what_jax_accepts():
    """Fast weights and luma-only levels on the chained stored paths."""
    c, v, n, z = (torch.from_numpy(a) for a in _planes(46, 8, 8)[:4])
    for kw in (dict(weight_math="fast"), dict(weight_math="fast",
                                              bwd_impl="stored_f32"),
               dict(params=SVGFParams(luma_only_from=3)),
               dict(params=SVGFParams(luma_only_from=3), bwd_impl="none")):
        oc, ov = svgf_spatial_ad_cuda(c, v, n, z, **kw)
        assert oc.shape == (3, 8, 8) and bool(torch.isfinite(ov).all())


@pytest.mark.parametrize("spatial_bwd,atol", [("stored", 3e-3),
                                              ("stored_f32", 2e-4),
                                              ("recompute", 2e-4)])
def test_denoise_frame_spatial_bwd_matches_plain(spatial_bwd, atol):
    c, v, n, z, wc, _, _ = _planes(47)
    hist = _planes(48)[0]
    t = torch.from_numpy
    params = SVGFParams(radius=1, iterations=3)
    grads = []
    for kw in (dict(impl="auto", spatial_bwd=spatial_bwd),
               dict(impl="plain")):
        render = t(c).clone().requires_grad_()
        hc = t(hist).clone().requires_grad_()
        g = GBuffer(render=render, albedo=torch.full((3, H, W), 0.7),
                    normal=t(n), depth=t(z),
                    motion=torch.full((2, H, W), 0.25))
        h = History(color=hc, moments=torch.stack([t(v), 2 * t(v)]),
                    length=torch.full((H, W), 3.0), prev_depth=t(z),
                    prev_normal=t(n))
        out, _ = svgf_denoise_frame(g, h, params=params, temporal="ad", **kw)
        (out.denoised * t(wc)).sum().backward()
        grads.append((render.grad, hc.grad))
    _close(grads[0], grads[1], atol_max=atol, names=("d_render", "d_hist"))


def test_denoise_frame_rejects_unknown_spatial_bwd():
    c, v, n, z = (torch.from_numpy(a) for a in _planes(49, 8, 8)[:4])
    g = GBuffer(render=c, albedo=c, normal=n, depth=z)
    with pytest.raises(ValueError, match="spatial_bwd"):
        svgf_denoise_frame(g, History.zeros(8, 8, device="cpu"),
                           spatial_bwd="fused")
    with pytest.raises(ValueError, match="weight_grads=True"):
        svgf_denoise_frame(g, History.zeros(8, 8, device="cpu"),
                           detach_weights=False)
