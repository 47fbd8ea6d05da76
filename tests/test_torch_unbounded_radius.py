"""Two reaches of the port that its kernels lacked, against the JAX
package: the à-trous sweep at any radius (here 0 and 3; the level kernels
took 1 and 2 only) and the temporal step with unbounded motion
(``SVGFParams.max_motion=None``: the clamped bilinear gather and its
adjoint, where K3-K6 take bounded motion only).  On CPU tensors every
wrapper runs its plain twin; the kernels are held to these twins on the
card (``tests/test_torch_cuda.py``).

Tolerances:
* the sweep at r = 0 and 3 against ``svgf_spatial_ref(detach_weights=
  True)``: rtol 5e-5 as at r = 1, 2 (``tests/test_torch_spatial.py``);
  its gradients through the recompute adjoint against ``jax.grad``: rtol
  1e-4, atol 1e-6 (``tests/test_sharded.py``'s bound for the sweep's
  VJP);
* the clamped gather and its VJP against ``jax.vjp`` of
  ``bilinear_gather_many``: rtol 1e-5, atol 1e-6 (the same sums; the
  port rounds the bilinear sums as fused multiply-adds, as XLA does), on
  a planar stack and on the channel-minor history stack that the card's
  route builds (``history_stack_channel_minor``: ``history_stack``'s
  values exactly);
* ``svgf_denoise_frame(impl="auto", max_motion=None)`` against JAX's
  ``impl="reference"``: the frame and history rtol 5e-5, atol 1e-6 (the
  sweep's bound); for ``temporal="ad"`` the gradients of the loss with
  respect to the history colour and the motion, against ``jax.grad``, at
  atol 3e-3·max (the kernel path's sweep adjoint multiplies bf16-stored
  weights, as in the train step's tests).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.models.svgf import (
    svgf_denoise_frame as j_svgf_denoise_frame)
from raymarchdenoisercuda_tpu.ops.atrous import (
    svgf_spatial_ref as j_svgf_spatial_ref)
from raymarchdenoisercuda_tpu.ops.temporal import (
    bilinear_gather_many as j_bilinear_gather_many)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import History
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import atrous_cuda
from raymarchdenoisercuda_torch.ops.atrous import _spline_taps
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    svgf_spatial_ad_cuda, svgf_spatial_cuda)
from raymarchdenoisercuda_torch.ops.temporal import (
    GRAD_PLANES, history_stack, history_stack_channel_minor)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    clamped_gather_bwd_cuda, clamped_gather_cuda,
    history_stack_channel_minor_cuda, reproject_clamped_cuda)

H, W = 32, 48
SH, SW = 24, 32          # the sweep's shape (49 taps a level at r = 3)


def _planes(seed, H=H, W=W):
    rng = np.random.default_rng(seed)
    color = rng.random((3, H, W), dtype=np.float32)
    variance = (0.02 * rng.random((H, W))).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    return color, variance, n, depth


@pytest.mark.parametrize("radius", [0, 3])
@pytest.mark.parametrize("luma_only_from", [None, 1])
def test_sweep_any_radius_matches_jnp_oracle(radius, luma_only_from):
    color, variance, normal, depth = _planes(20 + radius, SH, SW)
    kw = dict(radius=radius, iterations=3, luma_only_from=luma_only_from)
    want = j_svgf_spatial_ref(color, variance, normal, depth,
                              params=JSVGFParams(**kw), detach_weights=True,
                              return_feedback=True)
    got = svgf_spatial_cuda(*(torch.from_numpy(a) for a in (
        color, variance, normal, depth)), params=SVGFParams(**kw),
        return_feedback=True)
    for name, a, b in zip(("color", "variance", "feedback"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("radius", [0, 3])
def test_sweep_any_radius_gradients_match_jax(radius):
    color, variance, normal, depth = _planes(30 + radius, SH, SW)
    kw = dict(radius=radius, iterations=2)

    def loss(c, v):
        oc, ov = j_svgf_spatial_ref(c, v, normal, depth,
                                    params=JSVGFParams(**kw),
                                    detach_weights=True)
        return jnp.sum(oc ** 2) + jnp.sum(ov)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(color),
                                          jnp.asarray(variance))
    c, v = (torch.from_numpy(a).requires_grad_() for a in (color, variance))
    oc, ov = svgf_spatial_ad_cuda(c, v, torch.from_numpy(normal),
                                  torch.from_numpy(depth),
                                  params=SVGFParams(**kw),
                                  bwd_impl="recompute")
    got = torch.autograd.grad((oc ** 2).sum() + ov.sum(), (c, v))
    for name, a, b in zip(("d_color", "d_variance"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5])
def test_wide_taps_ride_outside_the_parameter_struct(radius):
    """Up to r = 2 the taps ride in the 72-byte ``AtrousParams`` as before
    (no device array); above, the struct's taps are zero and the kernels
    read the 2r+1 taps from a device array, one a (radius, device)."""
    assert ctypes.sizeof(atrous_cuda._AtrousParams) == 72
    p = atrous_cuda._launch_params(8, 8, 1, SVGFParams(radius=radius))
    taps = _spline_taps(radius)
    wide = atrous_cuda._wide_taps(radius, torch.device("cpu"))
    if radius <= 2:
        assert wide is None
        np.testing.assert_array_equal(list(p.taps)[:len(taps)],
                                      np.float32(taps))
    else:
        assert list(p.taps) == [0.0] * 5
        np.testing.assert_array_equal(wide.numpy(), np.float32(taps))
        assert atrous_cuda._wide_taps(radius, torch.device("cpu")) is wide


@pytest.mark.parametrize("scale", [0.0, 7.0, 80.0])
def test_clamped_gather_vjp_matches_jax(scale):
    """The clamped gather and its adjoint's plain form, for a cotangent on
    the first ``GRAD_PLANES`` planes (the adjoint's rule), against
    ``jax.vjp`` of ``bilinear_gather_many`` (motion out to ±40 pixels
    clamps taps at the border); a cotangent on the other planes is
    ignored."""
    rng = np.random.default_rng(5)
    stack = rng.random((10, 12, 16), dtype=np.float32)
    mot = ((rng.random((2, 12, 16)) - 0.5) * scale).astype(np.float32)
    full = rng.standard_normal((10, 12, 16)).astype(np.float32)
    cot = full.copy()
    cot[GRAD_PLANES:] = 0.0
    iy = np.arange(12, dtype=np.float32)[:, None]
    ix = np.arange(16, dtype=np.float32)[None, :]

    def j_gather(s, m):
        return j_bilinear_gather_many([s], iy + m[0], ix + m[1])[0]

    out, vjp = jax.vjp(jax.jit(j_gather), jnp.asarray(stack),
                       jnp.asarray(mot))
    want = vjp(jnp.asarray(cot))
    s, m = torch.from_numpy(stack), torch.from_numpy(mot)
    np.testing.assert_allclose(clamped_gather_cuda(s, m).numpy(),
                               np.asarray(out), rtol=1e-5, atol=1e-6)
    got = clamped_gather_bwd_cuda(s, m, torch.from_numpy(cot))
    for name, a, b in zip(("d_stack", "d_motion"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # autograd through the differentiable wrapper gives the same
    sl, ml = s.clone().requires_grad_(), m.clone().requires_grad_()
    d = torch.autograd.grad(reproject_clamped_cuda(sl, ml), (sl, ml),
                            torch.from_numpy(cot))
    for a, b in zip(d, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(clamped_gather_bwd_cuda(s, m, torch.from_numpy(full)),
                    got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert clamped_gather_bwd_cuda(s, m, torch.from_numpy(cot),
                                   history_grad=False)[0] is None


def test_channel_minor_stack_matches_history_stack_and_jax():
    """``history_stack_channel_minor`` on CPU tensors holds
    ``history_stack``'s values with strides (1, 10·W, 10), and the plain
    gather and its adjoint given it match ``jax.vjp`` of
    ``bilinear_gather_many`` (motion to ±10 pixels clamps taps at the
    border); the history colour's gradient through the stack builder is
    the adjoint's first three planes; KGp's wrapper returns this stack on
    the CPU.  5 x 7 pixels, one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h, w = 5, 7
        rng = np.random.default_rng(9)
        planes = {k: rng.random(s, dtype=np.float32) for k, s in (
            ("color", (3, h, w)), ("moments", (2, h, w)),
            ("length", (h, w)), ("prev_depth", (h, w)),
            ("prev_normal", (3, h, w)))}
        color = torch.from_numpy(planes["color"]).requires_grad_()
        hist = History(**{k: torch.from_numpy(v) for k, v in
                          planes.items()}).replace(color=color)
        stack = history_stack_channel_minor(hist)
        assert stack.shape == (10, h, w)
        assert stack.stride() == (1, 10 * w, 10)
        planar = history_stack(hist).detach()
        np.testing.assert_array_equal(stack.detach().numpy(),
                                      planar.numpy())
        # the card's wrapper (KGp) runs this twin on CPU tensors
        assert torch.equal(history_stack_channel_minor_cuda(hist), stack)
        mot = ((rng.random((2, h, w)) - 0.5) * 20.0).astype(np.float32)
        cot = rng.standard_normal((10, h, w)).astype(np.float32)
        cot[GRAD_PLANES:] = 0.0
        iy = np.arange(h, dtype=np.float32)[:, None]
        ix = np.arange(w, dtype=np.float32)[None, :]

        def j_gather(s, m):
            return j_bilinear_gather_many([s], iy + m[0], ix + m[1])[0]

        out, vjp = jax.vjp(jax.jit(j_gather), jnp.asarray(planar.numpy()),
                           jnp.asarray(mot))
        want = vjp(jnp.asarray(cot))
        m = torch.from_numpy(mot)
        with torch.no_grad():
            got_out = clamped_gather_cuda(stack, m)
            got = clamped_gather_bwd_cuda(stack, m, torch.from_numpy(cot))
        np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                                   rtol=1e-5, atol=1e-6)
        for name, a, b in zip(("d_stack", "d_motion"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        d_color, = torch.autograd.grad(reproject_clamped_cuda(stack, m),
                                       (color,), torch.from_numpy(cot))
        np.testing.assert_allclose(d_color.numpy(), got[0][:3].numpy(),
                                   rtol=1e-6, atol=1e-7)
    finally:
        torch.set_num_threads(threads)


def _frame_inputs(seed):
    rng = np.random.default_rng(seed)
    color, variance, n, depth = _planes(seed)
    g = dict(render=color, albedo=np.full((3, H, W), 0.7, np.float32),
             normal=n, depth=depth,
             motion=((rng.random((2, H, W)) - 0.5) * 30.0).astype(
                 np.float32))
    h = dict(color=color[:, :, ::-1].copy(),
             moments=np.stack([variance, 2 * variance]),
             length=np.floor(variance * 300).astype(np.float32),
             prev_depth=depth, prev_normal=n)
    return g, h


@pytest.mark.parametrize("temporal", ["auto", "ad"])
def test_unbounded_motion_frame_matches_jax(temporal):
    """``svgf_denoise_frame(impl="auto")`` with ``max_motion=None``, the
    fused entry (the clamped gather, the inference sweep) and the
    differentiable one (its adjoint, the stored sweep)."""
    g, h = _frame_inputs(50)
    kw = dict(radius=1, iterations=3, max_motion=None)

    def j_run(hc, mot):
        gb = JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}).replace(
            motion=mot)
        hb = JHistory(**{k: jnp.asarray(v) for k, v in h.items()}).replace(
            color=hc)
        return j_svgf_denoise_frame(gb, hb, params=JSVGFParams(**kw),
                                    impl="reference")

    jout, jhist = j_run(jnp.asarray(h["color"]), jnp.asarray(g["motion"]))
    ad = temporal == "ad"
    hc = torch.from_numpy(h["color"]).requires_grad_(ad)
    mot = torch.from_numpy(g["motion"]).requires_grad_(ad)
    gb = convert.gbuffer_from_numpy(g, "cpu").replace(motion=mot)
    hb = convert.history_from_numpy(h, "cpu").replace(color=hc)
    out, hist = svgf_denoise_frame(gb, hb, params=SVGFParams(**kw),
                                   impl="auto", temporal=temporal)
    np.testing.assert_allclose(out.denoised.detach().numpy(),
                               np.asarray(jout.denoised), rtol=5e-5,
                               atol=1e-6)
    for name in ("color", "moments", "length"):
        np.testing.assert_allclose(getattr(hist, name).detach().numpy(),
                                   np.asarray(getattr(jhist, name)),
                                   rtol=5e-5, atol=1e-6, err_msg=name)
    if not ad:
        return

    def j_loss(hc, mot):
        return jnp.mean(j_run(hc, mot)[0].denoised ** 2)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(h["color"]),
                                            jnp.asarray(g["motion"]))
    got = torch.autograd.grad((out.denoised ** 2).mean(), (hc, mot))
    for name, a, b in zip(("d_history_color", "d_motion"), got, want):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=3e-3 * np.abs(b).max(), err_msg=name)
