"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports no jax, so it also runs where only the port's
dependencies are installed:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)

Tolerances, each the one its CPU parity test uses against the JAX package:
K1 rtol 5e-5 (exact weights) or atol 2e-4·max (fast weights); K3 rtol 1e-5,
atol 1e-6, length exact; K7/K8 atol 1e-4 (normal atol 5e-4, rtol 5e-3)
outside pixels whose hit, material or visibility flips on an ulp (at most
0.1 %); the slice atol 1e-3·max on the denoised frame.  Training path:
K1's stored bf16 weights within one bf16 step (rtol 2^-7: expf and
torch.exp can round a weight to either side of a bf16 rounding boundary;
fast weights also move by up to 1.4e-4 at the polynomial's seams) and N
as K1's values; K2 rtol 1e-6 (same operations in the same order); K4 and
K5/K6 rtol 1e-5, atol 1e-6 (K5/K6 add by atomics, in no fixed order); the
2-step train step, kernel path against plain path, loss rtol 1e-5,
albedo gradient atol 3e-3·max (the stored bf16 weights; the plain path
differentiates the float weights), updated albedo atol 1e-5.  Filters and
K13 (the JAX package's kernel-vs-oracle tolerances): K10 rtol 1e-5, atol
1e-6 (the kernel sums the 2-D window, its twin sums separably); K11 atol
1e-5; K12 atol 5e-5 (exp2f of log2(e)-scaled arguments and repeated
squaring against exp and pow); K13 at most 0.1 % visibility flips, as K8.
"""

import numpy as np
import pytest
import torch

from raymarchdenoisercuda_torch.config import (
    CameraParams, FilterParams, FilterType, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import (
    init_train_state, make_train_step, render_and_denoise)
from raymarchdenoisercuda_torch.ops import (atrous, boxfilter, filters,
                                            raymarch, temporal)
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level_bwd_stored_cuda, atrous_level_cuda, svgf_spatial_cuda,
    svgf_spatial_stored_cuda)
from raymarchdenoisercuda_torch.ops.common import finite_diff_gradients
from raymarchdenoisercuda_torch.ops.filters_cuda import (
    box_filter_cuda, cross_bilateral_cuda, gaussian_filter_cuda)
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    march_gbuf_cuda, shadow_factor_cuda, shadow_shade_cuda)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    gather_bwd_cuda, gather_bwd_hist_cuda, gather_cuda,
    temporal_accumulate_ad_cuda, temporal_accumulate_cuda)

pytestmark = pytest.mark.cuda

H, W = 135, 240


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(dev, seed, H=H, W=W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (t(rng.random((3, H, W))), t(0.02 * rng.random((H, W))), t(n),
            t(0.3 + 0.5 * rng.random((H, W))))


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("weight_math", ["exact", "fast"])
@pytest.mark.parametrize("luma_only_from", [None, 3])
def test_k1_matches_plain(dev, radius, weight_math, luma_only_from):
    planes = _planes(dev, radius)
    params = SVGFParams(radius=radius, luma_only_from=luma_only_from)
    got = svgf_spatial_cuda(*planes, params=params, weight_math=weight_math,
                            return_feedback=True)
    want = atrous.svgf_spatial_ref(*planes, params=params,
                                   weight_math=weight_math,
                                   return_feedback=True)
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        if weight_math == "exact":
            np.testing.assert_allclose(a, b, rtol=5e-5)
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2e-4 * np.abs(b).max())


def test_k1_rejects_bad_inputs(dev):
    color, var, normal, depth = _planes(dev, 0, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        svgf_spatial_cuda(color.double(), var, normal, depth)
    with pytest.raises(ValueError, match="contiguous"):
        svgf_spatial_cuda(color.transpose(1, 2).contiguous().transpose(1, 2),
                          var.t().contiguous().t(), normal,
                          depth.t().contiguous().t())
    with pytest.raises(ValueError, match="radius"):
        svgf_spatial_cuda(color, var, normal, depth,
                          params=SVGFParams(radius=3))


@pytest.mark.parametrize("motion_scale", [0.0, 3.0, 14.0])
@pytest.mark.parametrize("boost", [4, 0])
def test_k3_matches_plain(dev, motion_scale, boost):
    color, var, normal, depth = _planes(dev, 7)
    rng = np.random.default_rng(8)
    motion = torch.from_numpy(((rng.random((2, H, W)) - 0.5) * motion_scale)
                              .astype(np.float32)).to(dev)
    g = GBuffer(render=color, albedo=color, normal=normal, depth=depth,
                motion=motion)
    h = History(color=color.flip(-1).contiguous(),
                moments=torch.stack([var, var * 2]),
                length=torch.floor(var * 300), prev_depth=depth,
                prev_normal=normal)
    params = SVGFParams(variance_boost_frames=boost)
    got = temporal_accumulate_cuda(g, h, params=params)
    want = temporal.temporal_accumulate(g, h, params=params)
    tol = dict(rtol=1e-5, atol=1e-6)
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2].moments, want[2].moments)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    np.testing.assert_array_equal(_np(got[2].length), _np(want[2].length))


def test_k3_rejects_unbounded_motion(dev):
    color, var, normal, depth = _planes(dev, 9, 8, 8)
    g = GBuffer(render=color, albedo=color, normal=normal, depth=depth)
    with pytest.raises(ValueError, match="max_motion"):
        temporal_accumulate_cuda(g, History.zeros(8, 8, device=dev),
                                 params=SVGFParams(max_motion=None))


def _compare_gbuffers(got, want):
    flipped = ((got.albedo - want.albedo).abs().amax(0) > 1e-4) | (
        (got.depth - want.depth).abs() > 1e-4) | (
        (got.render - want.render).abs().amax(0) > 1e-2)
    assert float(flipped.float().mean()) <= 1e-3, int(flipped.sum())
    keep = ~flipped
    for name in ("render", "albedo", "normal", "depth", "motion"):
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        tol = (dict(rtol=5e-3, atol=5e-4) if name == "normal"
               else dict(rtol=0, atol=1e-4))
        np.testing.assert_allclose(a[..., _np(keep)], b[..., _np(keep)],
                                   err_msg=name, **tol)


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("scene_name", ["cornell", "random"])
def test_k7_k8_match_plain(dev, omega, scene_name):
    scene = (raymarch.cornell_scene(device=dev) if scene_name == "cornell"
             else raymarch.random_scene(seed=3, device=dev))
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams(relax_omega=omega)
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    args = (scene, orbit_camera(0.25, device=dev),
            orbit_camera(0.1875, device=dev))
    got = raymarch.render_gbuffer(*args, cam_cfg=cfg, params=rm,
                                  light_sample=lp)
    want = raymarch.render_gbuffer(*args, cam_cfg=cfg, params=rm,
                                   light_sample=lp, impl="plain")
    _compare_gbuffers(got, want)


def test_slice_kernel_path_matches_plain(dev):
    scene = raymarch.cornell_scene(device=dev)
    cfg = dict(cam_cfg=CameraParams(width=W, height=H),
               rm_params=RaymarchParams(), svgf_params=SVGFParams(radius=1),
               weight_math="fast")
    hk = hp = History.zeros(H, W, device=dev)
    prev = None
    for f in range(3):
        cam = orbit_camera(f / 16, device=dev)
        lp = raymarch.sample_light(
            scene, torch.Generator(dev).manual_seed(f), (H, W))
        ok, hk = render_and_denoise(scene, cam, prev, hk, light_sample=lp,
                                    **cfg)
        op, hp = render_and_denoise(scene, cam, prev, hp, light_sample=lp,
                                    impl="plain", **cfg)
        a, b = _np(ok.denoised), _np(op.denoised)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())
        prev = cam


def test_wrappers_count_launches(dev):
    color, var, normal, depth = _planes(dev, 11, 16, 16)
    before = atrous_level_cuda.launches
    svgf_spatial_cuda(color, var, normal, depth,
                      params=SVGFParams(iterations=3))
    assert atrous_level_cuda.launches == before + 3
    before = atrous_level_cuda.launches
    svgf_spatial_cuda(*(t.cpu() for t in (color, var, normal, depth)))
    assert atrous_level_cuda.launches == before      # CPU: plain, no launch


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("weight_math", ["exact", "fast"])
def test_k1_store_mode_and_k2_match_plain(dev, radius, weight_math):
    color, var, normal, depth = _planes(dev, 20 + radius)
    zgrad = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius)
    g = torch.Generator(dev).manual_seed(radius)
    gc = torch.randn((3, H, W), generator=g, device=dev)
    gv = torch.randn((H, W), generator=g, device=dev)
    for level in (0, 3):
        kw = dict(level=level, params=params, weight_math=weight_math)
        c, v, w, norm = atrous_level_cuda(color, var, normal, depth, zgrad,
                                          store=True, **kw)
        c0, v0, w0, n0 = atrous.atrous_level_ref(
            color, var, normal, depth, zgrad, return_weights=True, **kw)
        tol = (dict(rtol=5e-5, atol=0) if weight_math == "exact"
               else dict(rtol=0, atol=2e-4 * float(c0.abs().max())))
        for a, b in ((c, c0), (norm, n0)):
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        assert w.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(w.float()),
                                   _np(w0.to(torch.bfloat16).float()),
                                   rtol=2.0 ** -7, atol=1e-30)
        # K2 and its twin on the same stored weights
        got = atrous_level_bwd_stored_cuda(w, norm, gc, gv, level=level,
                                           radius=radius)
        want = atrous.atrous_level_bwd_stored_ref(w, norm, gc, gv,
                                                  level=level, radius=radius)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-12 * float(b.abs().max()))


def _motion(dev, kind, seed, M=6):
    rng = np.random.default_rng(seed)
    m = (rng.random((2, H, W)) - 0.5) * 2 * (M + 1)   # some beyond M
    if kind == "zero":
        m = np.zeros((2, H, W))
    elif kind == "integer":
        m = np.round(m)
    return torch.from_numpy(m.astype(np.float32)).to(dev)


@pytest.mark.parametrize("kind", ["zero", "integer", "fractional"])
def test_k4_k5_k6_match_plain(dev, kind):
    rng = np.random.default_rng(30)
    stack = torch.from_numpy(rng.random((10, H, W), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    motion = _motion(dev, kind, 31)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gather_cuda(stack, motion, 6)),
                               _np(temporal.gather_ref(stack, motion, 6)),
                               **tol)
    for grad_planes in (6, 10):
        got = gather_bwd_cuda(stack, motion, g, 6, grad_planes=grad_planes)
        want = temporal.gather_bwd_ref(stack, motion, g, 6, motion_grad=True,
                                       grad_planes=grad_planes)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        assert float(got[1].abs().max()) > 0
        dh, dm = gather_bwd_hist_cuda(motion, g, 6, grad_planes=grad_planes)
        np.testing.assert_allclose(_np(dh), _np(want[0]), **tol)
        assert float(dm.abs().max()) == 0.0
        assert float(dh[grad_planes:].abs().sum()) == 0.0


def test_wrappers_keep_or_refuse_gradients(dev):
    """Every kernel wrapper either returns a result with a ``grad_fn`` or
    raises when an input requires grad: none loses a gradient silently."""
    color, var, normal, depth = _planes(dev, 40, 16, 24)
    c = color.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        svgf_spatial_cuda(c, var, normal, depth)
    out, _ = svgf_spatial_stored_cuda(c, var, normal, depth)
    assert out.grad_fn is not None
    gb = GBuffer(render=c, albedo=color, normal=normal, depth=depth,
                 motion=torch.zeros((2, 16, 24), device=dev))
    hist = History.zeros(16, 24, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        temporal_accumulate_cuda(gb, hist)
    integ, _, _ = temporal_accumulate_ad_cuda(gb, hist)
    assert integ.grad_fn is not None
    scene = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=24, height=16)
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
    with pytest.raises(RuntimeError, match="no backward"):
        march_gbuf_cuda(scene, ro.requires_grad_(), rd, RaymarchParams())
    t, hit, mat, n = march_gbuf_cuda(scene, ro.detach(), rd, RaymarchParams())
    p = ro.detach() + t[None] * rd
    alb = torch.full((3, 16, 24), 0.5, device=dev, requires_grad=True)
    render, _, _ = shadow_shade_cuda(
        scene, p, n, p + 1.0, alb, torch.zeros_like(p), hit,
        raymarch.light_constants(scene), None, RaymarchParams(), (24, 16))
    assert render.grad_fn is not None
    render.sum().backward()
    assert float(alb.grad.abs().max()) > 0


def test_train_step_kernel_path_matches_plain(dev):
    scene = raymarch.cornell_scene(device=dev)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (3, H, W), dtype=np.float32)).to(dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H),
              rm_params=RaymarchParams(),
              svgf_params=SVGFParams(iterations=5, radius=1))
    runs = {}
    for impl in ("auto", "plain"):
        step = make_train_step(scene, raymarch.cornell_camera(device=dev),
                               target, impl=impl, **kw)
        state = init_train_state(scene.materials.albedo, H, W,
                                 torch.Generator(dev).manual_seed(0))
        runs[impl] = []
        for _ in range(2):
            state, loss = step(state)
            runs[impl].append((float(loss), state.albedo.grad.clone(),
                               state.albedo.detach().clone()))
    for (lk, gk, ak), (lp, gp, ap) in zip(runs["auto"], runs["plain"]):
        assert np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)
        np.testing.assert_allclose(_np(gk), _np(gp), rtol=0,
                                   atol=3e-3 * float(gp.abs().max()))
        np.testing.assert_allclose(_np(ak), _np(ap), rtol=0, atol=1e-5)


# (135, 240) is a multiple of neither block side (32x8 filters, 16x8
# raymarch); (37, 53) is smaller than one block row
SHAPES = [(H, W), (37, 53)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,depth", [(2, 1), (1, 3)])
def test_k10_matches_plain(dev, shape, radius, depth):
    x = _planes(dev, 50, *shape)[0]
    before = box_filter_cuda.launches
    got = box_filter_cuda(x, radius=radius, depth=depth)
    assert box_filter_cuda.launches == before + depth
    np.testing.assert_allclose(
        _np(got), _np(boxfilter.box_filter(x, radius=radius, depth=depth)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("depth", [1, 2])
def test_k11_matches_plain(dev, shape, depth):
    x = _planes(dev, 51, *shape)[0]
    got = gaussian_filter_cuda(x, radius=2, sigma=2.0, depth=depth)
    want = filters.gaussian_filter(x, radius=2, sigma=2.0, depth=depth)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma_normal", [128.0, 3.0])
def test_k12_matches_plain(dev, shape, sigma_normal):
    color, _var, normal, depth = _planes(dev, 52, *shape)
    albedo = _planes(dev, 53, *shape)[0]
    p = FilterParams(type=FilterType.CROSS, sigma_normal=sigma_normal)
    got = cross_bilateral_cuda(color, albedo, normal, depth, params=p)
    want = filters.cross_bilateral_filter(color, albedo, normal, depth,
                                          params=p)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=5e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("scene_name", ["cornell", "random"])
def test_k13_matches_plain(dev, shape, omega, scene_name):
    h, w = shape
    scene = (raymarch.cornell_scene(device=dev) if scene_name == "cornell"
             else raymarch.random_scene(seed=3, device=dev))
    rm = RaymarchParams(relax_omega=omega)
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev),
                                     CameraParams(width=w, height=h))
    t, _hit, _mat, n = raymarch.march_gbuf(scene, ro, rd, rm)
    p = ro + t[None] * rd
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(1),
                               (h, w))
    got = shadow_factor_cuda(scene, p, n, lp, rm)
    want = raymarch.shadow_factor(scene, p, n, lp, rm)
    assert got.shape == (h, w)
    assert float((got != want).float().mean()) <= 1e-3


def test_spp_render_kernel_path_matches_plain(dev):
    scene = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    lp = torch.stack([raymarch.sample_light(
        scene, torch.Generator(dev).manual_seed(s), (H, W)) for s in range(4)])
    args = (scene, orbit_camera(0.25, device=dev),
            orbit_camera(0.1875, device=dev))
    before = shadow_factor_cuda.launches
    got = raymarch.render_gbuffer(*args, cam_cfg=cfg, light_sample=lp, spp=4)
    assert shadow_factor_cuda.launches == before + 4
    want = raymarch.render_gbuffer(*args, cam_cfg=cfg, light_sample=lp, spp=4,
                                   impl="plain")
    _compare_gbuffers(got, want)


@pytest.mark.parametrize("ftype", list(FilterType))
def test_apply_filter_kernel_path_matches_plain(dev, ftype):
    color, var, normal, depth = _planes(dev, 54)
    g = GBuffer(render=color, albedo=_planes(dev, 55)[0], normal=normal,
                depth=depth)
    p = FilterParams(type=ftype, depth=2)
    got = filters.apply_filter(g, p, var).denoised
    want = filters.apply_filter(g, p, var, impl="plain").denoised
    tol = {FilterType.AVERAGE: dict(rtol=1e-5, atol=1e-6),
           FilterType.GAUSSIAN: dict(rtol=0, atol=1e-5),
           FilterType.CROSS: dict(rtol=0, atol=5e-5),
           FilterType.WAVELET: dict(rtol=5e-5, atol=0)}[ftype]
    np.testing.assert_allclose(_np(got), _np(want), **tol)
