"""``SVGFParams.pyramid_from`` (the half-resolution deep levels) in the
port's plain sweep against the JAX package's jnp oracle, and the paths
that refuse it.

Tolerances (relative to the compared plane's max|·|): the sweep's values
and feedback at atol 5e-5·max (the JAX package's 5-level oracle bound,
ROADMAP North star; measured ≤ 5e-6), its colour and variance gradients,
weights detached or not, at atol 2e-4·max (the VJP bound; measured ≤
2e-5): both are float32 renderings of one algorithm, differing by
rounding order (XLA:CPU fuses multiply-adds; ``jax.image.resize`` sums its
two bilinear taps by a matrix product).  ``_down2`` and ``_up2`` at atol
1e-6 (≤ 2 float32 ulps of values in [0, 1]).

The kernel path (``svgf_spatial_ad_cuda``, ``svgf_spatial_cuda``,
``svgf_denoise_frame(impl="auto")``) and the sharded sweep raise as JAX's
Pallas and sharded paths do; ``svgf_denoise_frame(impl="plain")`` and the
quality gate's plain path run it, as JAX's ``impl="reference"`` does."""

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
from raymarchdenoisercuda_tpu.ops import atrous as ja
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import atrous as ta
from raymarchdenoisercuda_torch.ops.atrous_cuda import (svgf_spatial_ad_cuda,
                                                        svgf_spatial_cuda)
from raymarchdenoisercuda_torch.parallel.mesh import make_mesh
from raymarchdenoisercuda_torch.parallel.sharded import svgf_spatial_sharded
from raymarchdenoisercuda_torch.utils import denoise_quality as dq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small operations on a few thousand pixels: one intra-op thread
    runs them as fast and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return (rng.random((3, H, W), dtype=np.float32),
            (0.02 * rng.random((H, W))).astype(np.float32), n,
            (0.3 + 0.5 * rng.random((H, W))).astype(np.float32),
            rng.standard_normal((3, H, W)).astype(np.float32),
            rng.standard_normal((H, W)).astype(np.float32))


def _close(got, want, atol_rel, name):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= atol_rel * scale, \
        f"{name}: {err:.3g} > {atol_rel}·{scale:.3g}"


@pytest.mark.parametrize("shape", [(7, 9), (8, 10), (5, 6), (1, 3)])
def test_down2_up2_match_jax_on_odd_extents(shape):
    h, w = shape
    x = np.random.default_rng(h * 10 + w).random((3, h, w), dtype=np.float32)
    _close(ta._down2(torch.from_numpy(x)), ja._down2(jnp.asarray(x)), 1e-6,
           "down2")
    _close(ta._down2(torch.from_numpy(x[0])), ja._down2(jnp.asarray(x[0])),
           1e-6, "down2 (H, W)")
    for H, W in ((2 * h, 2 * w), (2 * h - 1, 2 * w - 1)):
        _close(ta._up2(torch.from_numpy(x), H, W),
               ja._up2(jnp.asarray(x), H, W), 1e-6, "up2")


@pytest.mark.parametrize("pf,radius,shape", [
    (3, 1, (37, 45)), (2, 2, (36, 41)), (1, 1, (29, 34))])
def test_pyramid_sweep_values_match_jax(pf, radius, shape):
    c, v, n, z, _, _ = _planes(pf * 7 + radius, *shape)
    jc, jv, jf = ja.svgf_spatial_ref(
        *map(jnp.asarray, (c, v, n, z)),
        params=JSVGFParams(radius=radius, pyramid_from=pf),
        return_feedback=True)
    tc, tv, tf = ta.svgf_spatial_ref(
        *map(torch.from_numpy, (c, v, n, z)),
        params=SVGFParams(radius=radius, pyramid_from=pf),
        return_feedback=True)
    for name, got, want in (("c", tc, jc), ("v", tv, jv),
                            ("feedback", tf, jf)):
        _close(got, want, 5e-5, name)
    assert float(tv.min()) >= 0.0


@pytest.mark.parametrize("detach", [True, False])
def test_pyramid_sweep_gradients_match_jax(detach):
    c, v, n, z, gc, gv = _planes(11, 33, 38)
    jp = JSVGFParams(radius=1, pyramid_from=3)

    def jloss(c_, v_):
        oc, ov = ja.svgf_spatial_ref(c_, v_, jnp.asarray(n), jnp.asarray(z),
                                     params=jp, detach_weights=detach)
        return jnp.sum(oc * gc) + jnp.sum(ov * gv)

    jdc, jdv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(v))
    tcol = torch.from_numpy(c).requires_grad_(True)
    tvar = torch.from_numpy(v).requires_grad_(True)
    oc, ov = ta.svgf_spatial_ref(tcol, tvar, torch.from_numpy(n),
                                 torch.from_numpy(z),
                                 params=SVGFParams(radius=1, pyramid_from=3),
                                 detach_weights=detach)
    (torch.sum(oc * torch.from_numpy(gc))
     + torch.sum(ov * torch.from_numpy(gv))).backward()
    _close(tcol.grad, jdc, 2e-4, "d_color")
    _close(tvar.grad, jdv, 2e-4, "d_variance")


def test_pyramid_feedback_level_must_be_full_resolution():
    c, v, n, z, _, _ = (torch.from_numpy(a) for a in _planes(4, 16, 16))
    params = SVGFParams(iterations=5, radius=1, pyramid_from=2,
                        feedback_level=3)
    with pytest.raises(ValueError, match="feedback_level"):
        ta.svgf_spatial_ref(c, v, n, z, params=params, return_feedback=True)


def _gbuf(seed, H, W):
    rng = np.random.default_rng(seed)
    c, v, n, z, _, _ = _planes(seed, H, W)
    albedo = (0.2 + 0.8 * rng.random((3, H, W))).astype(np.float32)
    motion = np.zeros((2, H, W), np.float32)
    return dict(render=c, albedo=albedo, normal=n, depth=z, motion=motion)


def test_denoise_frame_plain_runs_pyramid_as_jax_reference():
    H, W = 24, 30
    planes = _gbuf(5, H, W)
    g = GBuffer(**{k: torch.from_numpy(a) for k, a in planes.items()})
    jg = JGBuffer(**{k: jnp.asarray(a) for k, a in planes.items()})
    out, hist = svgf_denoise_frame(
        g, History.zeros(H, W, device="cpu"),
        params=SVGFParams(radius=1, pyramid_from=2), impl="plain")
    jout, jhist = j_denoise(jg, JHistory.zeros(H, W),
                            params=JSVGFParams(radius=1, pyramid_from=2),
                            impl="reference")
    _close(out.denoised, jout.denoised, 5e-5, "denoised")
    _close(hist.color, jhist.color, 5e-5, "history colour")


def test_kernel_and_sharded_paths_refuse_pyramid():
    c, v, n, z, _, _ = (torch.from_numpy(a) for a in _planes(6, 16, 16))
    params = SVGFParams(radius=1, pyramid_from=3)
    for kw in (dict(), dict(bwd_impl="recompute"), dict(bwd_impl="none"),
               dict(precision="bf16")):
        with pytest.raises(NotImplementedError, match="pyramid_from"):
            svgf_spatial_ad_cuda(c, v, n, z, params=params, **kw)
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        svgf_spatial_cuda(c, v, n, z, params=params)
    g = GBuffer(**{k: torch.from_numpy(a)
                   for k, a in _gbuf(6, 16, 16).items()})
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        svgf_denoise_frame(g, History.zeros(16, 16, device="cpu"),
                           params=params, impl="auto")
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        svgf_spatial_sharded(c, v, n, z, mesh=make_mesh(), params=params)


def test_quality_gate_runs_pyramid_on_the_plain_path():
    seq = dq.render_sequence(size=24, frames=3, spp_ref=4, warmup=2,
                             device="cpu")
    q = dq.score(seq, iterations=5, radius=1, pyramid_from=3, impl="plain")
    assert "half resolution from 3" in q["metric"]
    assert np.isfinite(q["output_psnr_db"]) and q["output_ssim"] > 0
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        dq.score(seq, iterations=5, radius=1, pyramid_from=3)
