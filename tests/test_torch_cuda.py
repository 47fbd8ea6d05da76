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
0.1 %); the slice atol 1e-3·max on the denoised frame.
"""

import numpy as np
import pytest
import torch

from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import render_and_denoise
from raymarchdenoisercuda_torch.ops import atrous, raymarch, temporal
from raymarchdenoisercuda_torch.ops.atrous_cuda import svgf_spatial_cuda
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    temporal_accumulate_cuda)

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
    before = svgf_spatial_cuda.launches
    svgf_spatial_cuda(color, var, normal, depth,
                      params=SVGFParams(iterations=3))
    assert svgf_spatial_cuda.launches == before + 3
    before = svgf_spatial_cuda.launches
    svgf_spatial_cuda(*(t.cpu() for t in (color, var, normal, depth)))
    assert svgf_spatial_cuda.launches == before      # CPU: plain, no launch
