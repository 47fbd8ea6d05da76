"""``precision="bf16"`` through the sweep and the denoiser: the port's
``svgf_spatial_ad_cuda`` and ``svgf_denoise_frame`` in that precision on
CPU tensors (the plain twins of K1b's and K14's bf16 forms, held level by
level in ``tests/test_torch_bf16.py``) against the JAX package.

Tolerances, relative to the compared plane's max|·|:

* The sweep, ``svgf_spatial_ad_cuda(precision="bf16")`` against
  ``svgf_spatial_pallas(interpret=True, precision="bf16")`` (3 levels, r1):
  values and colour gradient at atol 2^-7·max (one bf16 step; measured
  1.4e-5, the gradient bit-equal: a level's difference can move a later
  level's bf16 roundings, 1e-3 at r2); and JAX's own criteria for the mode
  (``tests/test_atrous_pallas.py::test_bf16_mode_quality_and_gradients``):
  within 2 % of the float32 oracle's scale, gradient cosine > 0.995
  against the float32 oracle's gradient.
* ``weight_grads=True`` with bf16 (the bf16 forward, K9's float32
  adjoint): every input's gradient at cosine > 0.99 against the float32
  ``weight_grads`` sweep's.
* ``svgf_denoise_frame(precision="bf16")`` (the twins on the CPU) against
  JAX's ``svgf_denoise_frame(impl="reference")`` within the same 2 %;
  JAX's ``impl="pallas"`` has no interpret switch.  ``impl="plain"``
  ignores ``precision``: equal to its float32 result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.models.svgf import (
    svgf_denoise_frame as j_denoise)
from raymarchdenoisercuda_tpu.ops.atrous import (
    svgf_spatial_ref as j_svgf_spatial_ref)
from raymarchdenoisercuda_tpu.ops.pallas.atrous_tpu import (
    svgf_spatial_pallas)
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.pipeline import FramePipeline
from raymarchdenoisercuda_torch.models.svgf import (SVGFDenoiser,
                                                    svgf_denoise_frame)
from raymarchdenoisercuda_torch.ops.atrous_cuda import svgf_spatial_ad_cuda
from raymarchdenoisercuda_torch.ops.raymarch import cornell_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small bf16 operations on a few hundred pixels: one intra-op
    thread runs them as fast and leaves the cores to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed, H, W):
    """color, variance, normal, depth, and cotangents gc, gv."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return (rng.random((3, H, W), dtype=np.float32),
            (0.02 * rng.random((H, W))).astype(np.float32), n,
            (0.3 + 0.5 * rng.random((H, W))).astype(np.float32),
            rng.standard_normal((3, H, W)).astype(np.float32),
            rng.standard_normal((H, W)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def sweep_case():
    H, W = 19, 37
    c, v, n, z, gc, _ = _planes(1234, H, W)
    jp = JSVGFParams(iterations=3, radius=1)

    def jloss(col, precision):
        oc, _ = svgf_spatial_pallas(col, *map(jnp.asarray, (v, n, z)),
                                    params=jp, interpret=True,
                                    precision=precision)
        return jnp.sum(oc * gc), oc

    (_, jc16), jg16 = jax.value_and_grad(
        lambda col: jloss(col, "bf16"), has_aux=True)(jnp.asarray(c))
    want, _ = j_svgf_spatial_ref(*map(jnp.asarray, (c, v, n, z)), params=jp)
    g32 = jax.grad(lambda col: jnp.sum(j_svgf_spatial_ref(
        col, *map(jnp.asarray, (v, n, z)), params=jp)[0] * gc))(
        jnp.asarray(c))
    return dict(planes=(c, v, n, z, gc), jc16=np.asarray(jc16),
                jg16=np.asarray(jg16), want=np.asarray(want),
                g32=np.asarray(g32))


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b),
                                    1e-30))


@pytest.mark.parametrize("kw", [dict(), dict(chained=False),
                                dict(bwd_impl="none")])
def test_sweep_matches_interpret_bf16_and_jax_criteria(sweep_case, kw):
    c, v, n, z, gc = sweep_case["planes"]
    col = _t(c).requires_grad_(kw.get("bwd_impl") != "none")
    with torch.set_grad_enabled(col.requires_grad):
        oc, ov = svgf_spatial_ad_cuda(
            col, *map(_t, (v, n, z)),
            params=SVGFParams(iterations=3, radius=1), precision="bf16",
            **kw)
    assert _rel_err(oc, sweep_case["jc16"]) <= 2.0 ** -7
    scale = float(np.abs(sweep_case["want"]).max())
    err = float(np.abs(oc.detach().numpy() - sweep_case["want"]).max())
    assert err < 0.02 * scale
    if col.requires_grad:
        (oc * _t(gc)).sum().backward()
        assert _rel_err(col.grad, sweep_case["jg16"]) <= 2.0 ** -7
        assert _cos(col.grad.numpy(), sweep_case["g32"]) > 0.995


def test_sweep_weight_grads_runs_bf16_forward_f32_adjoint():
    """``weight_grads`` with bf16: the bf16 forward, then K9's float32
    adjoint (JAX's ``_atrous_bwd``); its gradients follow the float32
    weight_grads sweep's direction."""
    c, v, n, z, gc, _ = _planes(7, 16, 20)
    grads = {}
    for precision in ("f32", "bf16"):
        ins = [_t(a).requires_grad_(True) for a in (c, v, n, z)]
        oc, _ = svgf_spatial_ad_cuda(*ins, params=SVGFParams(iterations=2),
                                     weight_grads=True, precision=precision)
        (oc * _t(gc)).sum().backward()
        grads[precision] = [t.grad.numpy() for t in ins]
    for k in range(4):
        assert _cos(grads["bf16"][k], grads["f32"][k]) > 0.99, k


def _gbuf(seed, H, W):
    rng = np.random.default_rng(seed)
    c, v, n, z, _, _ = _planes(seed, H, W)
    albedo = (0.2 + 0.8 * rng.random((3, H, W))).astype(np.float32)
    motion = np.zeros((2, H, W), np.float32)
    return dict(render=c, albedo=albedo, normal=n, depth=z, motion=motion)


def test_denoise_frame_bf16_against_jax_reference():
    H, W = 20, 26
    planes = _gbuf(3, H, W)
    g = GBuffer(**{k: _t(a) for k, a in planes.items()})
    params = SVGFParams(radius=1, iterations=3)
    out, hist = svgf_denoise_frame(g, History.zeros(H, W, device="cpu"),
                                   params=params, precision="bf16")
    jout, jhist = j_denoise(
        JGBuffer(**{k: jnp.asarray(a) for k, a in planes.items()}),
        JHistory.zeros(H, W), params=JSVGFParams(radius=1, iterations=3),
        impl="reference")
    for got, want in ((out.denoised, jout.denoised),
                      (hist.color, jhist.color)):
        scale = float(np.abs(np.asarray(want)).max())
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
            < 0.02 * scale
    # the port's plain path ignores precision, as JAX's reference path does
    p16, h16 = svgf_denoise_frame(g, History.zeros(H, W, device="cpu"),
                                  params=params, precision="bf16",
                                  impl="plain")
    p32, h32 = svgf_denoise_frame(g, History.zeros(H, W, device="cpu"),
                                  params=params, impl="plain")
    assert torch.equal(p16.denoised, p32.denoised)
    assert torch.equal(h16.color, h32.color)
    assert not torch.equal(out.denoised, p32.denoised)


def test_denoiser_and_pipeline_take_precision():
    planes = _gbuf(9, 12, 14)
    g = GBuffer(**{k: _t(a) for k, a in planes.items()})
    out, _ = SVGFDenoiser(SVGFParams(radius=1), precision="bf16")(
        g, History.zeros(12, 14, device="cpu"))
    want, _ = svgf_denoise_frame(g, History.zeros(12, 14, device="cpu"),
                                 params=SVGFParams(radius=1),
                                 precision="bf16")
    assert torch.equal(out.denoised, want.denoised)
    pipe = FramePipeline(cornell_scene(device="cpu"), precision="bf16")
    assert pipe.denoiser.precision == "bf16"
