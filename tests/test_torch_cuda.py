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
K5/K6 rtol 1e-5, atol 1e-6 (K5/K6 add a texel's addends in another order
than the twin's), on random, integer, zero and the served frame's motion,
motion at ±M and ±(M + 1), a 1079 x 1917 frame and the canvas forms at the
frame's corners; K5, K6, K5c and K6c bit-equal on a second and third
launch (a fixed summation order) at 1080p, and past max_motion 59 (60
and 96, the source region in row bands) against the twin at the same
tolerances and repeated bit-equal, the canvas forms too; the
2-step train step, kernel path against plain path, loss rtol 1e-5,
albedo gradient atol 3e-3·max (the stored bf16 weights; the plain path
differentiates the float weights), updated albedo atol 1e-5.  Filters and
K13 (the JAX package's kernel-vs-oracle tolerances): K10 rtol 1e-5, atol
1e-6 (the kernel sums the 2-D window, its twin sums separably), at every
compiled radius and the generic body's, at depths split into launches
past the halo cap, and bit-equal to one level a call; K11 atol 1e-5, and
bit-equal to its twin (the same products in the same order); K12 atol
5e-5 (exp2f of log2(e)-scaled arguments and repeated
squaring against exp and pow) at radii 0-4 (its staged form) and 5 and 16
(one thread a pixel), on a 1079 x 1917 frame too, and 17 and 24 (its
taps in a device array); K10 and K11 at radius 17, 24 and 90 (two 1-D
passes a level, K11's taps in a device array), bit-equal to their twins
(the same sums in the same order); K13 at most 0.1 %
visibility flips, as K8,
in each of its instantiations (counted under the key the scene's counts
pick).  K3 also on a frame of sides no multiple of its 32 x 8 tile, with
the history clamp off, and with one short pixel in the whole frame (one
block runs the 7x7 boost).
The adjoints (``chip_smoke.py`` phase 3's tolerances): K1b rtol 5e-5 as K1,
its float32 weights too; K2b rtol 1e-6 as K2; K14 atol 1e-5·max (K1's
weights, an ulp from the twin's, over cotangents of both signs); K9 atol
1e-4·max on each of its six planes.  The sweep of ``svgf_spatial_ad_cuda``,
kernel path against plain path (phase 9's): ``stored`` atol 3e-3·max,
``stored_f32``, ``recompute`` and ``chained=False`` 2e-4·max,
``weight_grads`` d_color and d_variance 1e-4·max, d_normal and d_depth
5e-4·max.

K14 at every radius and level, whole frame and 2x2 tiles, as K1/K1b:
atol 1e-5·max against the twin, the tiles' margin gradients summed against
the whole frame at rtol 1e-5.  K8 in each of its instantiations (the
Cornell box, ``random_scene``, and a scene of other counts: the runtime-
count one) at K7/K8's tolerance, its window bit-equal to the whole frame's
crop.  KGb run 20 times: every history gradient within one float32 ulp
of the first (its float64 sum is rounded once), the motion's bit-equal,
on a channel-minor stack (the unbounded-motion frame's) and on a planar
one (the wrappers lay it out with KGp); any other stack raises.
K7, K8, K13 and K15 on two scenes of the Cornell box's counts (one
constant buffer of compiled scene parameters a device) launched on three
streams at once: every output bit-equal to the same launch alone.  K15
in each instantiation and from the camera on windows up to a quarter of
3840x2160: delta and base bit-equal to the PyTorch glue's, the glue not
called on the card, the stops atol 1e-4 against ``cone_march`` and
bit-equal to the runtime-count instantiation and to K15 on the glue's
cones.
K7, seeded or not, in each compiled instantiation bit-equal to the
runtime-count instantiation on the same scene (the two SDFs do the same
operations in the same order), and a scene of other counts at K7's
tolerance against the twin.  K2 and K2b at every radius and level, whole
frame and tile form, bit-equal to the twin, which adds the same products
in the same tap order (a dropped tap adds an exact zero there).

The geometry adjoint: K7 and K7s (seeded from the camera) as the forward
of the implicit-function adjoint against the plain march on the card,
d(Σ w_t·t + Σ w_n·n) with respect to the spheres, boxes, planes and rd,
and ``render_gbuffer``'s loss (K7, then K8's hit-point and normal
cotangents) against ``impl="plain"``, atol 2e-3·max (the CPU tests'
bound against JAX), pixels whose hit, material or normal flips on an ulp
left out of the loss.

The tile forms (the sharded path's K1, K1b, K2, K14 with a tile origin and
the frame's bounds, K3b, K4c, K5c/K6c on canvases; ``chip_smoke.py``
phase 10(a)'s check at a small size): a frame is cut into 2x2 tiles and
into a row of tiles lower than the level-4 reach, each tile's canvas is
sliced from the frame (zeros past its border: what the halo exchange
delivers), and each kernel launched with the tile's origin is held to its
plain twin at the tolerances above and to the whole-frame kernel: the
forwards bit for bit at the tile's pixels; the adjoints, whose margin
gradients the tiles add up, within the atomics' or the summation's
rounding (rtol 1e-5).  The sharded paths on one card's (1, 1, 1) mesh
against the unsharded ones: the sweep bit for bit, the pipeline atol
1e-3·max, the train step as the unsharded one (loss rtol 1e-5, albedo
gradient atol 3e-3·max).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raymarchdenoisercuda_torch.config import (
    CameraParams, FilterParams, FilterType, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import (
    init_train_state, make_train_step, render_and_denoise)
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import (atrous, boxfilter, filters,
                                            raymarch, raymarch_cuda, temporal)
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level, atrous_level_bwd_cuda, atrous_level_bwd_stored_cuda,
    atrous_level_bwd_stored_f32_cuda, atrous_level_cuda,
    atrous_level_fwd_cuda, atrous_level_wgrad_bwd_cuda, svgf_spatial_ad_cuda,
    svgf_spatial_cuda, svgf_spatial_stored_cuda)
from raymarchdenoisercuda_torch.ops.common import (
    Tile, finite_diff_gradients, frame_canvas)
from raymarchdenoisercuda_torch.ops.filters_cuda import (
    box_filter_cuda, box_level_groups, cross_bilateral_cuda,
    gaussian_filter_cuda)
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (
    cone_seed_cuda, march_gbuf_cuda, march_gbuf_seeded_cuda,
    scene_key, shadow_factor_cuda, shadow_shade_cuda)
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    clamped_gather_bwd_cuda, clamped_gather_cuda, gather_bwd_cuda,
    gather_bwd_hist_cuda, gather_canvas_bwd_cuda,
    gather_canvas_bwd_hist_cuda, gather_canvas_cuda, gather_cuda,
    history_stack_channel_minor_cuda, reproject_clamped_cuda,
    temporal_accumulate_ad_cuda, temporal_accumulate_canvas_cuda,
    temporal_accumulate_cuda)
from raymarchdenoisercuda_torch.parallel import sharded
from raymarchdenoisercuda_torch.parallel.mesh import make_mesh
from raymarchdenoisercuda_torch.utils.seeded_inputs import gather_inputs

pytestmark = pytest.mark.cuda

H, W = 135, 240
# every radius the level kernels take: 1 and 2 ride in the parameter
# struct, 0 has one tap, 3 runs the WIDE instantiation (taps in memory)
RADII = [0, 1, 2, 3]


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


@pytest.mark.parametrize("radius", RADII)
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


# K3's inputs: motion scale, variance boost and kind: "frame" (135 x 240,
# 135 no multiple of the block's 8 rows), "odd" (133 x 237, neither side
# a multiple of the 32 x 8 tile), "no clamp" (history_clamp off) and "one
# short" (long valid histories, zero motion, one pixel of one block with
# a history of length 0: that block alone runs the 7x7 boost)
K3_CASES = [(scale, boost, "frame") for scale in (0.0, 3.0, 14.0)
            for boost in (4, 0)] + [
    (14.0, 4, "odd"), (3.0, 4, "no clamp"), (14.0, 0, "no clamp"),
    (0.0, 4, "one short")]


@pytest.mark.parametrize("motion_scale,boost,kind", K3_CASES,
                         ids=[f"{k} m{m:g} b{b}" for m, b, k in K3_CASES])
def test_k3_matches_plain(dev, motion_scale, boost, kind):
    h_, w_ = (133, 237) if kind == "odd" else (H, W)
    color, var, normal, depth = _planes(dev, 7, h_, w_)
    rng = np.random.default_rng(8)
    motion = torch.from_numpy(((rng.random((2, h_, w_)) - 0.5)
                               * motion_scale).astype(np.float32)).to(dev)
    g = GBuffer(render=color, albedo=color, normal=normal, depth=depth,
                motion=motion)
    length = torch.floor(var * 300)
    if kind == "one short":
        length = torch.full_like(length, 10.0)
        length[37, 101] = 0.0
    h = History(color=color.flip(-1).contiguous(),
                moments=torch.stack([var, var * 2]),
                length=length, prev_depth=depth, prev_normal=normal)
    params = SVGFParams(variance_boost_frames=boost,
                        history_clamp=kind != "no clamp")
    got = temporal_accumulate_cuda(g, h, params=params)
    want = temporal.temporal_accumulate(g, h, params=params)
    tol = dict(rtol=1e-5, atol=1e-6)
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2].moments, want[2].moments)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    np.testing.assert_array_equal(_np(got[2].length), _np(want[2].length))
    if kind == "one short":
        short = got[2].length < boost
        assert int(short.sum()) == 1 and bool(short[37, 101])


def test_k3_rejects_unbounded_motion(dev):
    """K3 itself takes bounded motion only, as the TPU kernel does: its
    tile form and K3b refuse ``max_motion=None``; the whole-frame wrapper
    runs the clamped gather instead and launches no K3."""
    color, var, normal, depth = _planes(dev, 9, 8, 8)
    g = GBuffer(render=color, albedo=color, normal=normal, depth=depth)
    unbounded = SVGFParams(max_motion=None)
    tile = Tile((0, 0), (8, 8))
    with pytest.raises(ValueError, match="max_motion"):
        temporal_accumulate_canvas_cuda(
            g, torch.zeros((10, 16, 16), device=dev), params=unbounded,
            tile=tile)
    with pytest.raises(ValueError, match="max_motion"):
        temporal_accumulate_cuda(g, History.zeros(8, 8, device=dev),
                                 params=unbounded, tile=tile)
    before = (temporal_accumulate_cuda.launches, clamped_gather_cuda.launches)
    temporal_accumulate_cuda(g, History.zeros(8, 8, device=dev),
                             params=unbounded)
    assert (temporal_accumulate_cuda.launches,
            clamped_gather_cuda.launches) == (before[0], before[1] + 1)


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


@pytest.mark.parametrize("radius", RADII)
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


def _motion(dev, kind, seed, M=6, H=H, W=W):
    rng = np.random.default_rng(seed)
    m = (rng.random((2, H, W)) - 0.5) * 2 * (M + 1)   # some beyond M
    if kind == "zero":
        m = np.zeros((2, H, W))
    elif kind == "integer":
        m = np.round(m)
    elif kind == "at M and M+1":
        # a third of the pixels exactly at ±M (accepted; the upper tap's
        # weight is 0) or ±(M + 1) (rejected) on either axis
        edge = rng.choice([-M - 1.0, -M, M, M + 1.0], size=(2, H, W))
        m = np.where(rng.random((2, H, W)) < 1 / 3, edge, m)
    return torch.from_numpy(m.astype(np.float32)).to(dev)


_SERVED = {}


def _served_gather_inputs(dev, H, W):
    """The served frame's history stack and motion (the camera's) with a
    seeded cotangent, computed once a size."""
    if (H, W) not in _SERVED:
        _SERVED[H, W] = gather_inputs(H, W, dev, "served")
    return _SERVED[H, W]


def _corner_tiles(H, W):
    """Tiles of ``H // 2 x W // 2`` at the frame's four corners."""
    th, tw = H // 2, W // 2
    for gy, gx in ((0, 0), (0, W - tw), (H - th, 0), (H - th, W - tw)):
        yield Tile((gy, gx), (H, W)), th, tw


def _check_canvas_gathers(stack, motion, g, M, tiles, tol):
    """K4c, K5c and K6c on each tile's history canvas (margin M + 1) against
    their twins, K4c bit-equal to the whole frame's K4 and K5c's motion
    gradient to the whole frame's K5 within ``tol``."""
    whole4 = gather_cuda(stack, motion, M)
    whole5 = gather_bwd_cuda(stack, motion, g, M, grad_planes=6)
    for tile, th, tw in tiles:
        canvas = frame_canvas(stack, tile, th, tw, M + 1)
        m_t, g_t = _crop(motion, tile, th, tw), _crop(g, tile, th, tw)
        k4 = gather_canvas_cuda(canvas, m_t, M, tile=tile)
        np.testing.assert_array_equal(_np(k4), _np(_crop(whole4, tile, th,
                                                         tw)))
        np.testing.assert_allclose(
            _np(k4), _np(temporal.gather_ref(canvas, m_t, M, tile=tile)),
            **tol)
        k5 = gather_canvas_bwd_cuda(canvas, m_t, g_t, M, tile=tile,
                                    grad_planes=6)
        want = temporal.gather_bwd_ref(canvas, m_t, g_t, M, motion_grad=True,
                                       grad_planes=6, tile=tile)
        for a, b in zip(k5, want):
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        k6 = gather_canvas_bwd_hist_cuda(m_t, g_t, M, tile=tile,
                                         canvas_shape=canvas.shape,
                                         grad_planes=6)
        np.testing.assert_allclose(_np(k6[0]), _np(want[0]), **tol)
        assert float(k6[1].abs().max()) == 0.0
        np.testing.assert_allclose(_np(k5[1]), _np(_crop(whole5[1], tile, th,
                                                         tw)), **tol)


K456_KINDS = ["zero", "integer", "fractional", "served", "at M and M+1",
              "odd frame", "corner tiles"]


@pytest.mark.parametrize("kind", K456_KINDS)
def test_k4_k5_k6_match_plain(dev, kind):
    """K4, K5 and K6 against their twins on zero, integer and fractional
    motion, the served frame's (coherent), motion exactly at ±M and
    ±(M + 1), on a 1079 x 1917 frame (sides no multiple of a block), and
    the canvas forms K4c-K6c on tiles at the frame's four corners."""
    h, w = (1079, 1917) if kind in ("odd frame", "corner tiles") else (H, W)
    rng = np.random.default_rng(30)
    stack = torch.from_numpy(rng.random((10, h, w), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((10, h, w)).astype(
        np.float32)).to(dev)
    if kind == "served":
        stack, motion, g = _served_gather_inputs(dev, h, w)
    else:
        motion = _motion(dev, kind, 31, H=h, W=w)
    tol = dict(rtol=1e-5, atol=1e-6)
    if kind == "corner tiles":
        _check_canvas_gathers(stack, motion, g, 6, _corner_tiles(h, w), tol)
        return
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


@pytest.mark.parametrize("max_motion", [30, 59, 60, 96])
def test_k5_k6_wide_max_motion(dev, max_motion):
    """K5/K6 at a max_motion whose source region needs more than 48 KB of
    shared memory (the launch's attribute; 59 needs 225 KB), and beyond
    59, where a block stages its region in row bands, against the twin, on
    motion to ±(max_motion + 1); a second and third launch bit-equal to
    the first (the bands keep each texel's order of additions)."""
    rng = np.random.default_rng(32)
    stack = torch.from_numpy(rng.random((10, H, W), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    motion = _motion(dev, "fractional", 33, M=max_motion)
    got = gather_bwd_cuda(stack, motion, g, max_motion, grad_planes=6)
    want = temporal.gather_bwd_ref(stack, motion, g, max_motion,
                                   motion_grad=True, grad_planes=6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    dh, _ = gather_bwd_hist_cuda(motion, g, max_motion, grad_planes=6)
    np.testing.assert_allclose(_np(dh), _np(want[0]), rtol=1e-5, atol=1e-6)
    for _ in range(2):
        again = gather_bwd_cuda(stack, motion, g, max_motion, grad_planes=6)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
        assert torch.equal(gather_bwd_hist_cuda(motion, g, max_motion,
                                                grad_planes=6)[0], dh)


@pytest.mark.parametrize("max_motion", [60, 96])
def test_k5c_k6c_wide_max_motion(dev, max_motion):
    """K5c/K6c (and K4c) past max_motion 59 on the canvases of the frame's
    corner tiles, against their twins and the whole frame's kernels
    (``test_k4_k5_k6_match_plain``'s corner tiles), repeated bit-equal."""
    rng = np.random.default_rng(34)
    stack = torch.from_numpy(rng.random((10, H, W), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    motion = _motion(dev, "fractional", 35, M=max_motion)
    tiles = list(_corner_tiles(H, W))
    _check_canvas_gathers(stack, motion, g, max_motion, tiles,
                          dict(rtol=1e-5, atol=1e-6))
    tile, th, tw = tiles[3]
    canvas = frame_canvas(stack, tile, th, tw, max_motion + 1)
    m_t, g_t = _crop(motion, tile, th, tw), _crop(g, tile, th, tw)
    first = gather_canvas_bwd_cuda(canvas, m_t, g_t, max_motion, tile=tile,
                                   grad_planes=6)
    again = gather_canvas_bwd_cuda(canvas, m_t, g_t, max_motion, tile=tile,
                                   grad_planes=6)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("kind", ["random", "served"])
@pytest.mark.parametrize("kernel", ["K5", "K6", "K5c", "K6c"])
def test_gather_adjoint_is_repeatable(dev, kernel, kind):
    """K5, K6, K5c and K6c launched three times at 1920x1080 on
    ``chip_smoke.py`` phase 3's kind of input (uniform random motion to ±7
    pixels, up to 196 sources a texel) and on the served frame's: every
    output bit-equal to the first launch's.  The canvas forms run on the
    frame's upper right quarter tile."""
    M = SVGFParams().max_motion
    if kind == "served":
        stack, motion, g = _served_gather_inputs(dev, 1080, 1920)
    else:
        stack, motion, g = gather_inputs(1080, 1920, dev, kind)
    if kernel.endswith("c"):
        tile, th, tw = Tile((0, 960), (1080, 1920)), 540, 960
        stack = frame_canvas(stack, tile, th, tw, M + 1)
        motion, g = _crop(motion, tile, th, tw), _crop(g, tile, th, tw)
    launch = {
        "K5": lambda: gather_bwd_cuda(stack, motion, g, M, grad_planes=6),
        "K6": lambda: gather_bwd_hist_cuda(motion, g, M, grad_planes=6),
        "K5c": lambda: gather_canvas_bwd_cuda(stack, motion, g, M, tile=tile,
                                              grad_planes=6),
        "K6c": lambda: gather_canvas_bwd_hist_cuda(
            motion, g, M, tile=tile, canvas_shape=stack.shape,
            grad_planes=6)}[kernel]
    first = launch()
    for run in (1, 2):
        for name, a, b in zip(("d_hist", "d_motion"), launch(), first):
            diff = int((a != b).sum())
            assert torch.equal(a, b), (run, name, diff)


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
    t, hit, mat, n = march_gbuf_cuda(scene, ro.clone().requires_grad_(), rd,
                                     RaymarchParams())
    assert t.grad_fn is not None and n.grad_fn is not None
    t, hit, mat, n = march_gbuf_cuda(scene, ro, rd, RaymarchParams())
    p = ro + t[None] * rd
    alb = torch.full((3, 16, 24), 0.5, device=dev, requires_grad=True)
    render, _, _ = shadow_shade_cuda(
        scene, p, n, p + 1.0, alb, torch.zeros_like(p), hit,
        raymarch.light_constants(scene), None, RaymarchParams(), (24, 16))
    assert render.grad_fn is not None
    render.sum().backward()
    assert float(alb.grad.abs().max()) > 0
    # the adjoint wrappers refuse; the level Function and sweep keep
    zg = finite_diff_gradients(depth)
    sd = atrous.sigma_denominator(var, SVGFParams())
    c2, v2, norm = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                         level=0, params=SVGFParams())
    for fn, args in (
            (atrous_level_fwd_cuda, (c, var, normal, depth, zg, sd)),
            (atrous_level_bwd_cuda, (c, normal, depth, zg, sd, norm, c2,
                                     v2)),
            (atrous_level_bwd_stored_f32_cuda, (
                torch.ones((25, 16, 24), device=dev), norm, c, v2)),
            (atrous_level_wgrad_bwd_cuda, (c, var, normal, depth, zg, sd,
                                           c2, v2, norm, c2, v2))):
        kw = (dict(level=0, radius=2) if fn is
              atrous_level_bwd_stored_f32_cuda
              else dict(level=0, params=SVGFParams()))
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args, **kw)
    out, _ = atrous_level(c, var, normal, depth, zg, sd, 0, SVGFParams(),
                          True)
    assert out.grad_fn is not None
    for kw in (dict(bwd_impl="recompute"), dict(bwd_impl="stored_f32"),
               dict(weight_grads=True)):
        out, _ = svgf_spatial_ad_cuda(c, var, normal, depth, **kw)
        assert out.grad_fn is not None


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


# (135, 240) is a multiple of neither tile side (64x32 K10/K11, 32x16
# K12, 16x8 raymarch); (37, 53) is smaller than one tile row
SHAPES = [(H, W), (37, 53)]


# K10's cases: every compiled radius (0-4) and the generic body (8, 16) at
# depth 1, and deeper calls, r2 d5 and r8 d2 past the halo one launch
# stages; K11's radii; both also on a frame of odd sides
K10_CASES = [(r, 1) for r in (0, 1, 2, 3, 4, 8, 16, 17, 24)] + [
    (1, 3), (2, 3), (2, 5), (8, 2), (17, 2)]
K11_RADII = [0, 1, 2, 4, 16, 17, 24]
FILTER_SHAPES = SHAPES + [(1079, 1917)]


@pytest.mark.parametrize("shape", FILTER_SHAPES)
@pytest.mark.parametrize("radius,depth", K10_CASES)
def test_k10_matches_plain(dev, shape, radius, depth):
    """K10 against its twin (which sums separably), launched as many
    times as ``box_level_groups`` splits the depth."""
    x = _planes(dev, 50, *shape)[0]
    before = box_filter_cuda.launches
    got = box_filter_cuda(x, radius=radius, depth=depth)
    # past r 16 two 1-D passes a level
    assert box_filter_cuda.launches == before + (
        len(box_level_groups(radius, depth)) if radius <= 16 else 2 * depth)
    np.testing.assert_allclose(
        _np(got), _np(boxfilter.box_filter(x, radius=radius, depth=depth)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", FILTER_SHAPES)
@pytest.mark.parametrize("radius,depth", [(0, 3), (1, 3), (2, 3), (2, 5),
                                          (3, 4), (8, 2), (24, 2)])
def test_k10_levels_of_one_launch_match_per_level_launches(dev, shape,
                                                           radius, depth):
    """Levels run in one launch's shared memory, and a call split into
    launches past the halo cap, are ``depth`` calls of one level bit for
    bit (the same taps, summed in the same order)."""
    x = _planes(dev, 56, *shape)[0] - 0.5
    want = x
    for _ in range(depth):
        want = box_filter_cuda(want, radius=radius, depth=1)
    assert torch.equal(box_filter_cuda(x, radius=radius, depth=depth), want)


@pytest.mark.parametrize("shape", FILTER_SHAPES)
@pytest.mark.parametrize("radius", K11_RADII)
@pytest.mark.parametrize("depth", [1, 2])
def test_k11_matches_plain(dev, shape, radius, depth):
    """K11 against its twin, one launch an iteration (past r 16, one a
    pass)."""
    x = _planes(dev, 51, *shape)[0]
    before = gaussian_filter_cuda.launches
    got = gaussian_filter_cuda(x, radius=radius, sigma=2.0, depth=depth)
    assert gaussian_filter_cuda.launches == before + depth * (
        1 if radius <= 16 else 2)
    want = filters.gaussian_filter(x, radius=radius, sigma=2.0, depth=depth)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", FILTER_SHAPES)
@pytest.mark.parametrize("radius", K11_RADII)
@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0])
def test_k11_bit_equal_to_twin(dev, shape, radius, sigma):
    """K11 adds its twin's products in its twin's order and divides as it
    does (the library built with --fmad=false): the same floats."""
    x = _planes(dev, 57, *shape)[0] - 0.5
    for depth in (1, 2):
        got = gaussian_filter_cuda(x, radius=radius, sigma=sigma, depth=depth)
        assert torch.equal(got, filters.gaussian_filter(
            x, radius=radius, sigma=sigma, depth=depth)), depth


# K12's radii: 0-4 run the staged form, 5 and 16 the one-thread-a-pixel
# body with the taps in its parameter struct, 17 and 24 with the taps in a
# device array
K12_RADII = [0, 1, 2, 3, 4, 5, 16, 17, 24]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [17, 90])
def test_k10_k11_separable_passes_bit_equal_to_twins(dev, shape, radius):
    """Past r 16 K10 and K11 run as their twins do, a pass along y and a
    pass along x a level, each adding the twin's terms in the twin's order:
    bit-equal to the twins at depth 1 and 2 (r 90 is wider than the
    (37, 53) frame)."""
    x = _planes(dev, 58, *shape)[0] - 0.5
    for depth in (1, 2):
        assert torch.equal(
            box_filter_cuda(x, radius=radius, depth=depth),
            boxfilter.box_filter(x, radius=radius, depth=depth)), depth
        assert torch.equal(
            gaussian_filter_cuda(x, radius=radius, sigma=30.0, depth=depth),
            filters.gaussian_filter(x, radius=radius, sigma=30.0,
                                    depth=depth)), depth


@pytest.mark.parametrize("radius", K12_RADII)
@pytest.mark.parametrize("shape", SHAPES + [(1079, 1917)])
@pytest.mark.parametrize("sigma_normal", [128.0, 3.0])
def test_k12_matches_plain(dev, shape, sigma_normal, radius):
    """K12 at every form's radii, on frames whose sides are no multiple of
    its 32 x 8 tile (one smaller than a tile), sigma_n by repeated
    squaring and by powf."""
    color, _var, normal, depth = _planes(dev, 52, *shape)
    albedo = _planes(dev, 53, *shape)[0]
    p = FilterParams(type=FilterType.CROSS, sigma_normal=sigma_normal,
                     radius=radius)
    got = cross_bilateral_cuda(color, albedo, normal, depth, params=p)
    want = filters.cross_bilateral_filter(color, albedo, normal, depth,
                                          params=p)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=5e-5)


# K13's scenes: the two it is compiled for and one of other counts (the
# runtime-count instantiation), with the key each runs
K13_SCENES = [("cornell", 1), ("random", 2), ("odd", 0)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("scene_name,key", K13_SCENES,
                         ids=[s[0] for s in K13_SCENES])
def test_k13_matches_plain(dev, shape, omega, scene_name, key):
    """K13 in each instantiation against ``raymarch.shadow_factor``, each
    launch counted under the key the scene's counts pick."""
    h, w = shape
    scene = _shade_scene(scene_name, dev)
    assert scene_key(scene) == key
    rm = RaymarchParams(relax_omega=omega)
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev),
                                     CameraParams(width=w, height=h))
    t, _hit, _mat, n = raymarch.march_gbuf(scene, ro, rd, rm)
    p = ro + t[None] * rd
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(1),
                               (h, w))
    before = shadow_factor_cuda.by_key[key]
    got = shadow_factor_cuda(scene, p, n, lp, rm)
    assert shadow_factor_cuda.by_key[key] == before + 1
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


ADJ_SHAPES = [((H, W), 1), ((37, 53), 4)]   # at level 4, every tap reach
                                            # crosses an image edge


@pytest.mark.parametrize("shape,level", ADJ_SHAPES)
@pytest.mark.parametrize("radius", RADII)
def test_adjoint_kernels_match_plain(dev, shape, level, radius):
    color, var, normal, depth = _planes(dev, 60 + radius, *shape)
    zg = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius)
    sd = atrous.sigma_denominator(var, params)
    g = torch.Generator(dev).manual_seed(radius)
    gc = torch.randn((3, *shape), generator=g, device=dev)
    gv = torch.randn(shape, generator=g, device=dev)
    kw = dict(level=level, params=params)
    got = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                save_weights=True, **kw)
    c0, v0, w0, n0 = atrous.atrous_level_ref(color, var, normal, depth, zg,
                                             sigma_denom=sd,
                                             return_weights=True, **kw)
    for a, b in zip(got, (c0, v0, n0, w0)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-5,
                                   atol=1e-12 * float(b.abs().max()))
    c, v, norm, w = got
    before = atrous_level_bwd_stored_f32_cuda.launches
    k2b = atrous_level_bwd_stored_cuda(w, norm, gc, gv, level=level,
                                       radius=radius)
    assert atrous_level_bwd_stored_f32_cuda.launches == before + 1
    for a, b in zip(k2b, atrous.atrous_level_bwd_stored_ref(
            w, norm, gc, gv, level=level, radius=radius)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                   atol=1e-12 * float(b.abs().max()))
    k14 = atrous_level_bwd_cuda(color, normal, depth, zg, sd, norm, gc, gv,
                                **kw)
    for a, b in zip(k14, atrous.atrous_level_bwd_ref(
            color, normal, depth, zg, sd, norm, gc, gv, **kw)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    wargs = (color, var, normal, depth, zg, sd, c, v, norm, gc, gv)
    k9 = atrous_level_wgrad_bwd_cuda(*wargs, **kw)
    for a, b in zip(k9, atrous.atrous_level_wgrad_bwd_ref(*wargs, **kw)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


# every level of the level kernels, whole frame and tiles: shapes that are
# not multiples of the kernels' row-lattice tiles (64 or 32 columns by 8
# lattice rows), and a 20x20 frame, whose every tap reach at level 4
# (s = 16) leaves the frame
LEVEL_SHAPES = [(37, 53), (20, 20)]
LEVEL_MATHS = [("fast", None), ("exact", None), ("fast", 0), ("exact", 0)]
STORES = [None, torch.bfloat16, torch.float32]


def _level_tol(weight_math, ref):
    return (dict(rtol=5e-5, atol=0) if weight_math == "exact"
            else dict(rtol=0, atol=2e-4 * float(ref.abs().max())))


def _quarter_tiles(shape):
    Hg, Wg = shape
    th, tw = (Hg + 1) // 2, (Wg + 1) // 2
    for gy in (0, th):
        for gx in (0, tw):
            yield Tile((gy, gx), (Hg, Wg)), min(th, Hg - gy), min(tw, Wg - gx)


@pytest.mark.parametrize("store", STORES, ids=["none", "bf16", "f32"])
@pytest.mark.parametrize("weight_math,luma_only_from", LEVEL_MATHS,
                         ids=["fast", "exact", "fast-luma", "exact-luma"])
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=["37x53", "20x20"])
def test_k1_every_level_whole_and_tiles(dev, shape, radius, weight_math,
                                        luma_only_from, store):
    """K1 at levels 0-4 against its plain twin (values and N at K1's
    tolerances, stored weights within one bf16 step or at rtol 5e-5), and
    its tile form on 2x2 tiles bit-equal to the whole-frame kernel."""
    color, var, normal, depth = _planes(dev, 100 + radius, *shape)
    zgrad = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius, luma_only_from=luma_only_from)
    extra = dict(store=True, store_dtype=store) if store else {}
    for level in range(5):
        kw = dict(level=level, params=params, weight_math=weight_math)
        got = atrous_level_cuda(color, var, normal, depth, zgrad, **extra,
                                **kw)
        want = atrous.atrous_level_ref(color, var, normal, depth, zgrad,
                                       return_weights=bool(store), **kw)
        if store:
            want = (want[0], want[1], want[2].to(store), want[3])
        for k, (a, b) in enumerate(zip(got, want)):
            a, b = a.float(), b.float()
            if k == 2 and store == torch.bfloat16:
                # one bf16 step, as test_k1_store_mode_and_k2_match_plain
                tol = dict(rtol=2.0 ** -7, atol=1e-30)
            elif k == 2 and weight_math == "exact":
                # float weights as K1b's
                tol = dict(rtol=5e-5, atol=1e-12 * float(b.abs().max()))
            else:
                tol = _level_tol(weight_math, b)
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        m = max(radius << level, 1)
        for tile, th, tw in _quarter_tiles(shape):
            lvl = [frame_canvas(x, tile, th, tw, m)
                   for x in (color, var, normal, depth)]
            gy, gx = tile.origin
            zg_t = zgrad[..., gy:gy + th, gx:gx + tw].contiguous()
            got_t = atrous_level_cuda(*lvl, zg_t, tile=tile, **extra, **kw)
            for a, w in zip(got_t, got):
                np.testing.assert_array_equal(
                    _np(a.float()), _np(w[..., gy:gy + th, gx:gx + tw].float()))


@pytest.mark.parametrize("save_weights", [False, True], ids=["N", "f32"])
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=["37x53", "20x20"])
def test_k1b_every_level_whole_and_tiles(dev, shape, radius, save_weights):
    """K1b (a given sigma denominator) at levels 0-4 against its plain twin
    at rtol 5e-5 (weights too), and its tile form bit-equal to the
    whole-frame kernel."""
    color, var, normal, depth = _planes(dev, 110 + radius, *shape)
    zgrad = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius)
    sd = atrous.sigma_denominator(var, params)
    for level in range(5):
        kw = dict(level=level, params=params)
        got = atrous_level_fwd_cuda(color, var, normal, depth, zgrad, sd,
                                    save_weights=save_weights, **kw)
        c0, v0, w0, n0 = atrous.atrous_level_ref(
            color, var, normal, depth, zgrad, sigma_denom=sd,
            return_weights=True, **kw)
        for a, b in zip(got, (c0, v0, n0, w0)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=5e-5,
                                       atol=1e-12 * float(b.abs().max()))
        m = max(radius << level, 1)
        for tile, th, tw in _quarter_tiles(shape):
            lvl = [frame_canvas(x, tile, th, tw, m)
                   for x in (color, var, normal, depth)]
            gy, gx = tile.origin
            crop = [x[..., gy:gy + th, gx:gx + tw].contiguous()
                    for x in (zgrad, sd)]
            got_t = atrous_level_fwd_cuda(*lvl, *crop, tile=tile,
                                          save_weights=save_weights, **kw)
            for a, w in zip(got_t, got):
                np.testing.assert_array_equal(
                    _np(a), _np(w[..., gy:gy + th, gx:gx + tw]))


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape", [(37, 53), (1080, 1920)],
                         ids=["37x53", "1080p"])
def test_k9_every_level_matches_plain(dev, shape, radius):
    """K9, one launch a call, at levels 0-4 against its plain twin (atol
    1e-4·max on each of its six planes)."""
    color, var, normal, depth = _planes(dev, 120 + radius, *shape)
    zg = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius)
    sd = atrous.sigma_denominator(var, params)
    g = torch.Generator(dev).manual_seed(radius)
    gc = torch.randn((3, *shape), generator=g, device=dev)
    gv = torch.randn(shape, generator=g, device=dev)
    for level in range(5):
        kw = dict(level=level, params=params)
        c, v, norm = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                           **kw)
        wargs = (color, var, normal, depth, zg, sd, c, v, norm, gc, gv)
        before = atrous_level_wgrad_bwd_cuda.launches
        got = atrous_level_wgrad_bwd_cuda(*wargs, **kw)
        assert atrous_level_wgrad_bwd_cuda.launches == before + 1
        for a, b in zip(got, atrous.atrous_level_wgrad_bwd_ref(*wargs, **kw)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


SWEEP_MODES = [("stored", dict(bwd_impl="stored"), (3e-3,) * 2),
               ("stored_f32", dict(bwd_impl="stored_f32"), (2e-4,) * 2),
               ("recompute", dict(bwd_impl="recompute"), (2e-4,) * 2),
               ("unchained", dict(chained=False), (2e-4,) * 2),
               ("weight_grads", dict(weight_grads=True),
                (1e-4, 1e-4, 5e-4, 5e-4))]


@pytest.mark.parametrize("name,kw,tols", SWEEP_MODES,
                         ids=[m[0] for m in SWEEP_MODES])
@pytest.mark.parametrize("radius", RADII)
def test_adjoint_sweep_kernel_path_matches_plain(dev, name, kw, tols,
                                                 radius):
    planes = _planes(dev, 70)
    g = torch.Generator(dev).manual_seed(70)
    cots = [torch.randn(t.shape, generator=g, device=dev)
            for t in (planes[0], planes[1], planes[0])]
    params = SVGFParams(radius=radius, iterations=5, feedback_level=1)
    wg = kw.get("weight_grads", False)
    grads = []
    for fn, fkw in ((svgf_spatial_ad_cuda, kw), (
            atrous.svgf_spatial_ref, dict(detach_weights=not wg))):
        ins = [t.clone().requires_grad_(k < 2 or wg)
               for k, t in enumerate(planes)]
        oc, ov, fb = fn(*ins, params=params, return_feedback=True, **fkw)
        loss = ((oc * cots[0]).sum() + (ov * cots[1]).sum()
                + (fb * cots[2]).sum())
        grads.append(torch.autograd.grad(loss, ins[:len(tols)]))
    for k, (a, b, tol) in enumerate(zip(*grads, tols)):
        if radius == 0 and k >= 2:
            # one tap: the output is its input whatever the weight, so
            # d_normal and d_depth are 0 but for rounding in both
            floor = 1e-3 * float(grads[1][0].abs().max())
            for x in (a, b):
                assert float(x.abs().max()) <= floor
            continue
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=tol * float(b.abs().max()))


def test_adjoint_sweep_counts_launches(dev):
    planes = [t.requires_grad_() for t in _planes(dev, 71, 16, 16)]
    params = SVGFParams(iterations=3)
    for kw, wrappers in (
            (dict(bwd_impl="stored_f32"),
             (atrous_level_cuda, atrous_level_bwd_stored_f32_cuda)),
            (dict(bwd_impl="recompute"),
             (atrous_level_fwd_cuda, atrous_level_bwd_cuda)),
            (dict(weight_grads=True),
             (atrous_level_fwd_cuda, atrous_level_wgrad_bwd_cuda))):
        before = [w.launches for w in wrappers]
        oc, ov = svgf_spatial_ad_cuda(*planes, params=params, **kw)
        (oc.sum() + ov.sum()).backward()
        assert [w.launches for w in wrappers] == [b + 3 for b in before]


# -- the tile and canvas forms of the sharded path -------------------------

TH, TW = 48, 64
TILINGS = [(2, 2), (6, 1)]     # 24x32 tiles; 8-row tiles below the reach


def _tiles(ny, nx):
    th, tw = TH // ny, TW // nx
    for iy in range(ny):
        for ix in range(nx):
            yield Tile((iy * th, ix * tw), (TH, TW)), th, tw


def _crop(x, tile, th, tw):
    gy, gx = tile.origin
    return x[..., gy:gy + th, gx:gx + tw].contiguous()


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("radius", [1, 2])
def test_level_tile_forms_match_plain_and_whole_frame(dev, tiling, radius):
    color, var, normal, depth = _planes(dev, 80 + radius, TH, TW)
    params = SVGFParams(radius=radius)
    zg = finite_diff_gradients(depth)
    sd = atrous.sigma_denominator(var, params)
    g = torch.Generator(dev).manual_seed(radius)
    gc = torch.randn((3, TH, TW), generator=g, device=dev)
    gv = torch.randn((TH, TW), generator=g, device=dev)
    for level in (1, 4):
        h = radius << level
        kw = dict(level=level, params=params)
        whole = atrous_level_cuda(color, var, normal, depth, zg, store=True,
                                  **kw)
        whole_b = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                        **kw)
        whole_k2 = atrous_level_bwd_stored_cuda(whole[2], whole[3], gc, gv,
                                                level=level, radius=radius)
        whole_k14 = atrous_level_bwd_cuda(color, normal, depth, zg, sd,
                                          whole_b[2], gc, gv, **kw)
        acc = [torch.zeros((3, TH + 2 * h, TW + 2 * h), device=dev),
               torch.zeros((TH + 2 * h, TW + 2 * h), device=dev)]
        acc14 = [torch.zeros_like(a) for a in acc]
        for tile, th, tw in _tiles(*tiling):
            cc, vc = (frame_canvas(x, tile, th, tw, h) for x in (color, var))
            # the guidance as views into a wider canvas (strides not the
            # view's own shape)
            nc, dc = (frame_canvas(x, tile, th, tw, h + 2)[..., 2:-2, 2:-2]
                      for x in (normal, depth))
            zg_t, sd_t, gc_t, gv_t = (_crop(x, tile, th, tw)
                                      for x in (zg, sd, gc, gv))
            got = atrous_level_cuda(cc, vc, nc, dc, zg_t, store=True,
                                    tile=tile, **kw)
            want = atrous.atrous_level_ref(cc, vc, nc, dc, zg_t,
                                           return_weights=True, tile=tile,
                                           **kw)
            for a, b, w in zip(got, want, whole):
                bf16 = a.dtype == torch.bfloat16
                a, b, w = a.float(), b.to(a.dtype).float(), w.float()
                np.testing.assert_array_equal(_np(a), _np(_crop(w, tile, th,
                                                                tw)))
                np.testing.assert_allclose(_np(a), _np(b), atol=1e-30,
                                           rtol=2.0 ** -7 if bf16 else 5e-5)
            got_b = atrous_level_fwd_cuda(cc, vc, nc, dc, zg_t, sd_t,
                                          tile=tile, **kw)
            for a, w in zip(got_b, whole_b):
                np.testing.assert_array_equal(_np(a), _np(_crop(w, tile, th,
                                                                tw)))
            k2 = atrous_level_bwd_stored_cuda(got[2], got[3], gc_t, gv_t,
                                              level=level, radius=radius,
                                              out_halo=h)
            k2_want = atrous.atrous_level_bwd_stored_ref(
                got[2], got[3], gc_t, gv_t, level=level, radius=radius,
                out_halo=h)
            k14 = atrous_level_bwd_cuda(cc, nc, dc, zg_t, sd_t, got_b[2],
                                        gc_t, gv_t, tile=tile, out_halo=h,
                                        **kw)
            k14_want = atrous.atrous_level_bwd_ref(
                cc, nc, dc, zg_t, sd_t, got_b[2], gc_t, gv_t, tile=tile,
                out_halo=h, **kw)
            gy, gx = tile.origin
            for a, b, w in zip(k2, k2_want, acc):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-12 * float(b.abs().max()))
                w[..., gy:gy + th + 2 * h, gx:gx + tw + 2 * h] += a
            for a, b, w in zip(k14, k14_want, acc14):
                np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                           atol=1e-5 * float(b.abs().max()))
                w[..., gy:gy + th + 2 * h, gx:gx + tw + 2 * h] += a
        # the tiles' margin gradients add up to the whole frame's adjoint
        for a, w in zip(acc + acc14, whole_k2 + whole_k14):
            np.testing.assert_allclose(_np(a[..., h:h + TH, h:h + TW]),
                                       _np(w), rtol=1e-5,
                                       atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("tiling", TILINGS)
def test_temporal_canvas_forms_match_plain_and_whole_frame(dev, tiling):
    color, var, normal, depth = _planes(dev, 90, TH, TW)
    M = SVGFParams().max_motion
    params = SVGFParams()
    rng = np.random.default_rng(91)
    motion = torch.from_numpy(((rng.random((2, TH, TW)) - 0.5) * 2 * (M + 1))
                              .astype(np.float32)).to(dev)
    stack = torch.cat([color.flip(-1), torch.stack([var, var * 2]),
                       torch.floor(var * 300)[None], depth[None],
                       normal]).contiguous()
    cot = torch.from_numpy(rng.standard_normal((10, TH, TW)).astype(
        np.float32)).to(dev)
    g = GBuffer(render=color, albedo=color, normal=normal, depth=depth,
                motion=motion)
    hist = temporal.history_from_stack(stack)
    whole = temporal_accumulate_cuda(g, hist, params=params)
    whole4 = gather_cuda(stack, motion, M)
    whole5 = gather_bwd_cuda(stack, motion, cot, M, grad_planes=6)
    mh = M + 1
    acc5 = torch.zeros((10, TH + 2 * mh, TW + 2 * mh), device=dev)
    acc6 = torch.zeros_like(acc5)
    tol = dict(rtol=1e-5, atol=1e-6)
    for tile, th, tw in _tiles(*tiling):
        canvas = frame_canvas(stack, tile, th, tw, mh)
        m_t, cot_t = _crop(motion, tile, th, tw), _crop(cot, tile, th, tw)
        g_t = GBuffer(render=frame_canvas(color, tile, th, tw, 3),
                      albedo=None, normal=_crop(normal, tile, th, tw),
                      depth=_crop(depth, tile, th, tw), motion=m_t)
        got = temporal_accumulate_canvas_cuda(g_t, canvas, params=params,
                                              tile=tile)
        # K3's tile form on separately exchanged planes: the same numbers
        got3 = temporal_accumulate_cuda(
            g_t, History(*(frame_canvas(getattr(hist, f), tile, th, tw, mh)
                           for f in ("color", "moments", "length",
                                     "prev_depth", "prev_normal"))),
            params=params, tile=tile)
        want = temporal.temporal_accumulate(
            g_t, temporal.history_from_stack(canvas), params=params,
            tile=tile)
        for a, a3, b, w in ((got[0], got3[0], want[0], whole[0]),
                            (got[1], got3[1], want[1], whole[1]),
                            (got[2].moments, got3[2].moments,
                             want[2].moments, whole[2].moments),
                            (got[2].length, got3[2].length, want[2].length,
                             whole[2].length)):
            np.testing.assert_array_equal(_np(a), _np(_crop(w, tile, th,
                                                            tw)))
            np.testing.assert_array_equal(_np(a), _np(a3))
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        k4 = gather_canvas_cuda(canvas, m_t, M, tile=tile)
        np.testing.assert_array_equal(_np(k4), _np(_crop(whole4, tile, th,
                                                         tw)))
        np.testing.assert_allclose(
            _np(k4), _np(temporal.gather_ref(canvas, m_t, M, tile=tile)),
            **tol)
        k5 = gather_canvas_bwd_cuda(canvas, m_t, cot_t, M, tile=tile,
                                    grad_planes=6)
        k5_want = temporal.gather_bwd_ref(canvas, m_t, cot_t, M,
                                          motion_grad=True, grad_planes=6,
                                          tile=tile)
        k6 = gather_canvas_bwd_hist_cuda(m_t, cot_t, M, tile=tile,
                                         canvas_shape=canvas.shape,
                                         grad_planes=6)
        for a, b in zip(k5, k5_want):
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        np.testing.assert_allclose(_np(k6[0]), _np(k5_want[0]), **tol)
        np.testing.assert_allclose(_np(k5[1]), _np(_crop(whole5[1], tile,
                                                         th, tw)), **tol)
        gy, gx = tile.origin
        acc5[:, gy:gy + th + 2 * mh, gx:gx + tw + 2 * mh] += k5[0]
        acc6[:, gy:gy + th + 2 * mh, gx:gx + tw + 2 * mh] += k6[0]
    for acc in (acc5, acc6):
        np.testing.assert_allclose(_np(acc[:, mh:mh + TH, mh:mh + TW]),
                                   _np(whole5[0]), **tol)


def test_sharded_paths_on_one_card(dev):
    """The sharded sweep, pipeline and train step on the (1, 1, 1) mesh
    against the unsharded paths, and the launches of the canvas forms."""
    mesh = make_mesh()
    planes = _planes(dev, 95, TH, TW)
    params = SVGFParams(iterations=5, radius=1)
    want = svgf_spatial_cuda(*planes, params=params)
    for bwd in ("none", "stored", "recompute"):
        got = sharded.svgf_spatial_sharded(*planes, mesh=mesh, params=params,
                                           impl="auto", bwd_impl=bwd)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))

    scene = raymarch.cornell_scene(device=dev)
    cfg = dict(cam_cfg=CameraParams(width=TW, height=TH),
               rm_params=RaymarchParams(max_steps=48, shadow_steps=24),
               svgf_params=SVGFParams(radius=1, iterations=3))
    run = sharded.make_sharded_pipeline(mesh, TH, TW, **cfg,
                                        weight_math="fast")
    hs = sharded.init_history_canvas(mesh, TH, TW, cfg["svgf_params"],
                                     device=dev)
    hu = History.zeros(TH, TW, device=dev)
    prev = None
    before = temporal_accumulate_canvas_cuda.launches
    for f in range(3):
        cam = orbit_camera(f / 16, device=dev)
        lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(f),
                                   (TH, TW))
        a, hs = run(scene, cam, prev, hs, light_sample=lp)
        with torch.no_grad():
            b, hu = render_and_denoise(scene, cam, prev, hu, light_sample=lp,
                                       weight_math="fast", **cfg)
        np.testing.assert_allclose(_np(a.denoised), _np(b.denoised), rtol=0,
                                   atol=1e-3 * float(b.denoised.abs().max()))
        prev = cam
    assert temporal_accumulate_canvas_cuda.launches == before + 3

    target = torch.rand((3, TH, TW), generator=torch.Generator(dev)
                        .manual_seed(1), device=dev)
    cam = raymarch.cornell_camera(device=dev)
    step_s = sharded.make_sharded_train_step(mesh, scene, cam, target, **cfg)
    step_u = make_train_step(scene, cam, target, **cfg)
    state_s = sharded.init_sharded_train_state(
        mesh, scene.materials.albedo, TH, TW, cfg["svgf_params"])
    state_u = init_train_state(scene.materials.albedo, TH, TW)
    counts = [w.launches for w in (gather_canvas_cuda,
                                   gather_canvas_bwd_hist_cuda)]
    for k in range(2):
        lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(k),
                                   (TH, TW))
        state_s, ls = step_s(state_s, light_sample=lp)
        state_u, lu = step_u(state_u, light_sample=lp)
        assert abs(float(ls) - float(lu)) <= 1e-5 * abs(float(lu))
        np.testing.assert_allclose(
            _np(state_s.albedo.grad), _np(state_u.albedo.grad), rtol=0,
            atol=3e-3 * float(state_u.albedo.grad.abs().max()))
    # the step differentiates the albedo only: K4c runs, its adjoint not
    assert [w.launches for w in (gather_canvas_cuda,
                                 gather_canvas_bwd_hist_cuda)] == [
        counts[0] + 2, counts[1]]


# ---------------------------------------------------------------------------
# the cone pre-march seed (K15, the seeded K7) and unbounded motion
# ---------------------------------------------------------------------------

# K8's and K15's scenes: the two they are compiled for and one of other
# counts (their runtime-count instantiation), with the key each runs
SHADE_SCENES = [("cornell", 1), ("random", 2), ("odd", 0)]


def _shade_scene(name, dev):
    if name == "cornell":
        return raymarch.cornell_scene(device=dev)
    if name == "random":
        return raymarch.random_scene(seed=3, device=dev)
    return raymarch.random_scene(n_spheres=7, n_boxes=4, seed=5, device=dev)


def _cone_inputs(dev, scene_name):
    scene = _shade_scene(scene_name, dev)
    cfg = CameraParams(width=W, height=H)
    cam = orbit_camera(0.25, device=dev)
    ro, rd, _ = raymarch.camera_rays(cam, cfg)
    return scene, cfg, cam, ro, rd


# K15's windows from the camera: (camera frame, window origin, window
# shape); "quarter4k" is the lower right quarter of a 3840x2160 frame, the
# sharded path's window on a 2x2 mesh
CONE_WINDOWS = {"camera": ((H, W), (0, 0), (H, W)),
                "window": ((2 * H, 2 * W), (H, W // 2), (H, W)),
                "quarter4k": ((2160, 3840), (1080, 1920), (1080, 1920))}


@pytest.mark.parametrize("route", ["planes", "camera", "window",
                                   "quarter4k"])
@pytest.mark.parametrize("scene_name,key", SHADE_SCENES,
                         ids=[s[0] for s in SHADE_SCENES])
def test_k15_matches_plain(dev, scene_name, key, route):
    """K15 from ray planes and from the camera (origin (0, 0), a window of
    a 4x frame at a non-zero origin, and a quarter of a 3840x2160 frame) in
    each instantiation (the compiled scenes and the runtime counts, counted
    under the key the scene's counts pick) against ``cone_march`` on the
    glue's cones: the same operations in the same order, so atol 1e-4 as
    K7's t; delta and base bit-equal to the glue's (the camera route
    builds its cones on the card)."""
    scene, cfg, cam, ro, rd = _cone_inputs(dev, scene_name)
    params = RaymarchParams(coarse_seed=True)
    assert scene_key(scene) == key
    if route == "planes":
        cones = raymarch.cone_rays(ro, rd)
        kw = {}
        shape = (H, W)
    else:
        (ch, cw), window, shape = CONE_WINDOWS[route]
        cfg = CameraParams(width=cw, height=ch)
        cones = raymarch.cone_rays_analytic(cam, cfg, *window, *shape)
        kw = dict(camera=cam, cam_cfg=cfg, window=window, shape=shape)
    kind = "planes" if route == "planes" else "camera"

    def counts():
        return (cone_seed_cuda.launches, cone_seed_cuda.by_key[key],
                cone_seed_cuda.by_route[kind])

    before = counts()
    t_c, delta, base = cone_seed_cuda(scene, params, ro, rd, **kw)
    assert counts() == tuple(v + 1 for v in before)
    assert delta.is_cuda and base.is_cuda
    assert t_c.shape == raymarch.seed_grid_shape(*shape)
    assert torch.equal(delta, cones[2]) and torch.equal(base, cones[3])
    want = raymarch.cone_march(scene, *cones, params)
    np.testing.assert_allclose(_np(t_c), _np(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("fov_y", [0.3, 0.6911, 1.2])
@pytest.mark.parametrize("frame,window,shape", [
    ((1080, 1920), (0, 0), (1080, 1920)),
    ((1080, 1920), (5, 7), (137, 243)),
    ((2160, 3840), (1080, 0), (1080, 1920))],
    ids=["1080p", "odd window", "4k lower left"])
def test_k15_camera_route_runs_on_the_card(dev, monkeypatch, fov_y, frame,
                                           window, shape):
    """With ``camera=``, K15 builds its cones on the card: the PyTorch glue
    (``cone_rays_analytic``) is not called, the pass counts one camera
    launch, and its delta and base are bit-equal to the glue's at several
    fields of view and windows (the glue's tan, reciprocal multiplies and
    true divisions, operation by operation); its stops are those of K15
    on the glue's cones, bit for bit."""
    scene = raymarch.cornell_scene(device=dev)
    cam = orbit_camera(0.4, device=dev)
    cfg = CameraParams(width=frame[1], height=frame[0], fov_y=fov_y)
    params = RaymarchParams(coarse_seed=True)
    cones = raymarch.cone_rays_analytic(cam, cfg, *window, *shape)

    def glue(*args):
        raise AssertionError("the camera route ran the PyTorch glue")

    monkeypatch.setattr(raymarch_cuda, "cone_rays_analytic", glue)
    before = cone_seed_cuda.by_route["camera"]
    t_c, delta, base = cone_seed_cuda(scene, params, camera=cam,
                                      cam_cfg=cfg, window=window, shape=shape)
    assert cone_seed_cuda.by_route["camera"] == before + 1
    assert torch.equal(delta, cones[2]) and torch.equal(base, cones[3])
    assert torch.equal(t_c, raymarch_cuda.cone_launch(scene, *cones,
                                                      params))


@pytest.mark.parametrize("scene_name,key", SHADE_SCENES[:2],
                         ids=[s[0] for s in SHADE_SCENES[:2]])
def test_k15_compiled_scene_matches_runtime_counts(dev, scene_name, key):
    """K15 in the instantiation compiled for the scene is ``torch.equal``
    to the runtime-count instantiation on the same cones (the two SDFs do
    the same operations in the same order); a compiled key given other
    counts raises."""
    scene, cfg, cam, ro, rd = _cone_inputs(dev, scene_name)
    params = RaymarchParams(coarse_seed=True)
    for cones in (raymarch.cone_rays(ro, rd),
                  raymarch.cone_rays_analytic(cam, cfg, 0, 0, H, W)):
        got = raymarch_cuda.cone_launch(scene, *cones, params)
        runtime = raymarch_cuda.cone_launch(scene, *cones, params, key=0)
        assert torch.equal(got, runtime)
        with pytest.raises(RuntimeError, match="rdt_cone_seed"):
            raymarch_cuda.cone_launch(scene, *cones, params, key=3 - key)


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("scene_name", ["cornell", "random"])
def test_seeded_k7_matches_plain_and_unseeded(dev, scene_name, omega):
    """The seeded K7 against the plain seeded march on the same seed grid
    (K7's tolerances), and against the unseeded K7 by the properties of
    ``tests/test_torch_cone_seed.py``."""
    scene, cfg, cam, ro, rd = _cone_inputs(dev, scene_name)
    p0 = RaymarchParams(relax_omega=omega)
    p1 = RaymarchParams(relax_omega=omega, coarse_seed=True)
    t_c = cone_seed_cuda(scene, p1, camera=cam, cam_cfg=cfg,
                         shape=(H, W))[0]
    before = march_gbuf_seeded_cuda.launches
    got = march_gbuf_seeded_cuda(scene, ro, rd, t_c, p1)
    assert march_gbuf_seeded_cuda.launches == before + 1
    want = raymarch.march_gbuf(scene, ro, rd, p1, seed=t_c)
    same = (got[1] == want[1]) & (got[2] == want[2])
    assert float((~same).float().mean()) <= 1e-3
    np.testing.assert_allclose(_np(got[0])[_np(same)],
                               _np(want[0])[_np(same)], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(got[3])[:, _np(same)],
                               _np(want[3])[:, _np(same)], rtol=5e-3,
                               atol=5e-4)
    # the route of render_gbuffer: the same seeded launch
    routed = march_gbuf_cuda(scene, ro, rd, p1, camera=cam, cam_cfg=cfg)
    assert torch.equal(routed[0], got[0])
    seed = raymarch.seed_plane(t_c, H, W)
    d_at = raymarch.sdf_scene(scene, ro + seed[None] * rd, want_mat=False)
    live = seed < p1.max_dist
    assert float(d_at[live].min()) >= 0.5 * p1.hit_eps
    t0, h0, _m0, _n0 = march_gbuf_cuda(scene, ro, rd, p0)
    assert float((h0 == got[1]).float().mean()) > 0.998
    both = h0 & got[1]
    dt = _np((t0 - got[0]).abs()[both])
    assert np.percentile(dt, 99) < 2 * p1.hit_eps
    assert bool((seed <= got[0] + 1e-5).all())


GEOMETRY = ("sphere_params", "box_params", "plane_params")


def _geometry_leaves(scene):
    geo = [getattr(scene, k).clone().requires_grad_() for k in GEOMETRY]
    return dataclasses.replace(scene, **dict(zip(GEOMETRY, geo))), geo


def _assert_grads_close(got, want, names, tol=2e-3):
    for name, a, b in zip(names, got, want):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=tol * float(b.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("scene_name", ["cornell", "random"])
def test_k7_geometry_gradients_match_plain(dev, scene_name, seeded):
    """K7 (K7s with the camera's seed) as the forward of the implicit-
    function adjoint, its normal's chain recomputed in the backward,
    against the plain march on the card (the normal by autograd at the hit
    point): d(Σ w_t·t + Σ w_n·n) with respect to the spheres, boxes,
    planes and rd at atol 2e-3·scale, the CPU tests' bound against JAX.
    Pixels whose hit, material or normal differs on an ulp (K7's tolerance,
    at most 0.1 %) carry no weight."""
    base, cfg, cam, ro, rd = _cone_inputs(dev, scene_name)
    rm = RaymarchParams(coarse_seed=seeded)
    seed = (cone_seed_cuda(base, rm, camera=cam, cam_cfg=cfg,
                           shape=(H, W))[0] if seeded else None)

    def kernel(scene, rdv):
        if seeded:
            return march_gbuf_seeded_cuda(scene, ro, rdv, seed, rm)
        return march_gbuf_cuda(scene, ro, rdv, rm)

    with torch.no_grad():
        k, q = kernel(base, rd), raymarch.march_gbuf(base, ro, rd, rm,
                                                     seed=seed)
    keep = ((k[1] == q[1]) & (k[2] == q[2]) & (
        (k[3] - q[3]).abs() <= 5e-4 + 5e-3 * q[3].abs()).all(0))
    assert float((~keep).float().mean()) <= 1e-3
    g = torch.Generator(dev).manual_seed(5)
    w_t = (torch.rand((H, W), generator=g, device=dev) + 0.5) * keep
    w_n = (torch.rand((3, H, W), generator=g, device=dev) - 0.5) * keep
    grads = []
    for impl in ("kernel", "plain"):
        scene, geo = _geometry_leaves(base)
        rdv = rd.clone().requires_grad_()
        counts = (march_gbuf_cuda.launches, march_gbuf_seeded_cuda.launches)
        t, _hit, _mat, n = (kernel(scene, rdv) if impl == "kernel" else
                            raymarch.march_gbuf(scene, ro, rdv, rm,
                                                seed=seed))
        ((w_t * t).sum() + (w_n * n).sum()).backward()
        grads.append([x.grad for x in geo] + [rdv.grad])
        if impl == "kernel":
            assert (march_gbuf_cuda.launches + march_gbuf_seeded_cuda.launches
                    == sum(counts) + 1)
    _assert_grads_close(grads[0], grads[1], GEOMETRY + ("rd",))


def test_render_gbuffer_geometry_gradient_matches_plain(dev):
    """``render_gbuffer`` on the card (K7, then K8, whose backward gives
    the hit point's and the normal's cotangents) against ``impl="plain"``
    on the card: d(Σ w·render + Σ depth + Σ w_m·motion) with respect to
    the scene's geometry at atol 2e-3·scale; flipped pixels as in
    ``test_k7_k8_match_plain`` carry no weight."""
    base = raymarch.cornell_scene(device=dev)
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    lp = raymarch.sample_light(base, torch.Generator(dev).manual_seed(0),
                               (H, W))
    cams = (orbit_camera(0.25, device=dev), orbit_camera(0.1875, device=dev))
    with torch.no_grad():
        a, b = (raymarch.render_gbuffer(base, *cams, cam_cfg=cfg, params=rm,
                                        light_sample=lp, impl=impl)
                for impl in ("auto", "plain"))
    keep = ~(((a.albedo - b.albedo).abs().amax(0) > 1e-4)
             | ((a.depth - b.depth).abs() > 1e-4)
             | ((a.render - b.render).abs().amax(0) > 1e-2))
    assert float((~keep).float().mean()) <= 1e-3
    gen = torch.Generator(dev).manual_seed(6)
    w = torch.rand((3, H, W), generator=gen, device=dev) * keep
    w_m = torch.rand((2, H, W), generator=gen, device=dev) * keep * 1e-3
    grads = []
    for impl in ("auto", "plain"):
        scene, geo = _geometry_leaves(base)
        gb = raymarch.render_gbuffer(scene, *cams, cam_cfg=cfg, params=rm,
                                     light_sample=lp, impl=impl)
        ((w * gb.render).sum() + (keep * gb.depth).sum()
         + (w_m * gb.motion).sum()).backward()
        grads.append([x.grad for x in geo])
    _assert_grads_close(grads[0], grads[1], GEOMETRY)


def test_seeded_render_and_pipeline_on_the_card(dev):
    """``render_and_denoise`` with ``coarse_seed`` launches K15 and the
    seeded K7 (and no unseeded K7), and denoises within the slice's
    atol 1e-3·max of the unseeded kernel path outside the pixels whose
    hit or material differs."""
    scene = raymarch.cornell_scene(device=dev)
    kw = dict(cam_cfg=CameraParams(width=W, height=H),
              svgf_params=SVGFParams(radius=1), weight_math="fast")
    cam = orbit_camera(0.0, device=dev)
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    before = (cone_seed_cuda.launches, march_gbuf_seeded_cuda.launches,
              march_gbuf_cuda.launches)
    empty = History.zeros(H, W, device=dev)
    a, _ = render_and_denoise(scene, cam, None, empty, light_sample=lp,
                              rm_params=RaymarchParams(coarse_seed=True), **kw)
    assert (cone_seed_cuda.launches, march_gbuf_seeded_cuda.launches,
            march_gbuf_cuda.launches) == (before[0] + 1, before[1] + 1,
                                          before[2])
    b, _ = render_and_denoise(scene, cam, None, empty, light_sample=lp,
                              rm_params=RaymarchParams(), **kw)
    same = (a.albedo == b.albedo).all(0) & ((a.depth > 0) == (b.depth > 0))
    assert float((~same).float().mean()) <= 2e-3
    assert np.isfinite(_np(a.denoised)).all()
    d = _np((a.denoised - b.denoised).abs().amax(0))[_np(same)]
    assert np.percentile(d, 99) < 1e-3 * float(b.denoised.abs().max())


def _f64_motion(motion):
    """The float64 motion whose coordinates p + motion are the float32
    coordinates the kernel samples at (exact: both sums fit a double)."""
    H, W = motion.shape[-2:]
    iy = torch.arange(H, dtype=torch.float32, device=motion.device)[:, None]
    ix = torch.arange(W, dtype=torch.float32, device=motion.device)[None, :]
    return torch.stack([(iy + motion[0]).double() - iy.double(),
                        (ix + motion[1]).double() - ix.double()])


def _stack_in(stack, layout):
    """``stack`` as given (planar) or laid out channel-minor, strides (1,
    P·W, P), as the main paths stack the history on the card."""
    if layout == "planar":
        return stack
    return stack.permute(1, 2, 0).contiguous().permute(2, 0, 1)


@pytest.mark.parametrize("layout", ["planar", "channel-minor"])
@pytest.mark.parametrize("kind", ["zero", "fractional", "outside"])
def test_clamped_gather_and_adjoint_match_plain(dev, kind, layout):
    """The clamped gather against ``bilinear_gather_clamped`` (rtol 1e-5, atol
    1e-6: the same fused multiply-adds), its adjoint against float64
    autograd of the plain twin (the atomics add in no fixed order; rtol
    1e-5, atol 1e-6·max), with the cotangent on the first ``GRAD_PLANES``
    planes (the adjoint's rule: a cotangent on the others is ignored);
    motion out to ±40 pixels clamps taps at the border; the stack
    channel-minor, or planar and laid out by KGp in the wrappers (one KGp
    launch each).  The float64 twin
    samples at the kernel's float32 coordinates p + motion
    (:func:`_f64_motion`): float64 coordinates move the bilinear fractions
    by up to an ulp of a float32 coordinate (7.6e-6 at x ~ 100), a
    difference of arithmetic, not of the sums' order."""
    rng = np.random.default_rng(31)
    planar = torch.from_numpy(rng.random((10, H, W),
                                         dtype=np.float32)).to(dev)
    stack = _stack_in(planar, layout)
    scale = {"zero": 0.0, "fractional": 7.0, "outside": 80.0}[kind]
    motion = torch.from_numpy(((rng.random((2, H, W)) - 0.5) * scale)
                              .astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    relayouts = int(layout == "planar")
    before = (clamped_gather_cuda.launches,
              history_stack_channel_minor_cuda.launches)
    got = clamped_gather_cuda(stack, motion)
    assert (clamped_gather_cuda.launches,
            history_stack_channel_minor_cuda.launches) == (
        before[0] + 1, before[1] + relayouts)
    assert got.is_contiguous()
    np.testing.assert_allclose(_np(got), _np(temporal.bilinear_gather_clamped(
        planar, motion)), rtol=1e-5, atol=1e-6)
    g = cot.clone()
    g[temporal.GRAD_PLANES:] = 0
    s64 = planar.double().requires_grad_()
    m64 = _f64_motion(motion).requires_grad_()
    want = torch.autograd.grad(temporal.bilinear_gather_clamped(s64, m64),
                               (s64, m64), g.double())
    before = (clamped_gather_bwd_cuda.launches,
              history_stack_channel_minor_cuda.launches)
    got = clamped_gather_bwd_cuda(stack, motion, g)
    assert (clamped_gather_bwd_cuda.launches,
            history_stack_channel_minor_cuda.launches) == (
        before[0] + 1, before[1] + relayouts)
    assert got[0].is_contiguous()
    for name, a, b in zip(("d_stack", "d_motion"), got, want):
        np.testing.assert_allclose(_np(a), _np(b.float()), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)
    # a cotangent on planes 6-9 changes nothing
    for a, b in zip(clamped_gather_bwd_cuda(stack, motion, cot), got):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert float(got[0][temporal.GRAD_PLANES:].abs().sum()) == 0.0
    # through autograd: the Function's backward is the kernel (a planar
    # stack laid out once, its gradient back through KGp's adjoint)
    s, m = (t.clone().requires_grad_() for t in (stack, motion))
    before = history_stack_channel_minor_cuda.launches
    out = reproject_clamped_cuda(s, m)
    d = torch.autograd.grad(out, (s, m), g)
    assert history_stack_channel_minor_cuda.launches == before + relayouts
    for a, b in zip(d, got):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_clamped_gather_refuses_other_stacks(dev):
    """KG and KGb take the 10 history planes channel-minor (or planar, laid
    out by KGp): another plane count, another layout or a channel-minor
    stack off its 16-byte alignment raises, from the wrapper or from the
    C entry, and launches nothing."""
    rng = np.random.default_rng(33)
    motion = torch.zeros((2, H, W), device=dev)
    planar = torch.from_numpy(rng.random((10, H, W),
                                         dtype=np.float32)).to(dev)
    buf = torch.empty(10 * H * W + 1, device=dev)
    shifted = buf[1:].view(H, W, 10).permute(2, 0, 1)
    shifted.copy_(planar)
    stacks = {"8 planes planar": planar[:8],
              "8 planes channel-minor": _stack_in(planar[:8], "channel-minor"),
              "transposed": planar.transpose(1, 2).contiguous()
              .transpose(1, 2),
              "off its alignment": shifted}
    for name, stack in stacks.items():
        before = (clamped_gather_cuda.launches,
                  clamped_gather_bwd_cuda.launches)
        with pytest.raises((ValueError, RuntimeError)):
            clamped_gather_cuda(stack, motion)
        with pytest.raises((ValueError, RuntimeError)):
            clamped_gather_bwd_cuda(stack, motion, torch.zeros(
                stack.shape, device=dev))
        assert (clamped_gather_cuda.launches,
                clamped_gather_bwd_cuda.launches) == before, name


def test_channel_minor_stack_matches_plain(dev):
    """KGp: the history's channel-minor stack bit-equal to
    ``history_stack_channel_minor`` (a copy), strides (1, 10·W, 10),
    counted; the gradient of a loss on it reaches the history planes as
    the stack's gradient cut back into them."""
    rng = np.random.default_rng(35)
    planes = [torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
              for s in ((3, H, W), (2, H, W), (H, W), (H, W), (3, H, W))]
    color = planes[0].clone().requires_grad_()
    h = History(color, *planes[1:])
    before = history_stack_channel_minor_cuda.launches
    got = history_stack_channel_minor_cuda(h)
    assert history_stack_channel_minor_cuda.launches == before + 1
    want = temporal.history_stack_channel_minor(h)
    assert got.stride() == (1, 10 * W, 10)
    assert torch.equal(got, want)
    cot = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    d_color, = torch.autograd.grad(got, (color,), cot)
    assert torch.equal(d_color, cot[:3])


@pytest.mark.parametrize("temporal_mode", ["auto", "ad"])
def test_unbounded_motion_frame_matches_plain(dev, temporal_mode):
    """``svgf_denoise_frame(impl="auto")`` with ``max_motion=None`` (the
    clamped gather on the channel-minor history stack from KGp, its
    adjoint for ``"ad"``, the sweep) against
    ``impl="plain"``: the frame atol 1e-3·max as the slice's; for ``"ad"``
    the gradients of the history colour and the motion at the training
    path's 3e-3·max (the stored bf16 sweep weights)."""
    color, var, normal, depth = _planes(dev, 40)
    rng = np.random.default_rng(41)
    motion = torch.from_numpy(((rng.random((2, H, W)) - 0.5) * 30.0)
                              .astype(np.float32)).to(dev)
    params = SVGFParams(radius=1, max_motion=None)
    outs, grads = [], []
    for impl in ("auto", "plain"):
        ad = temporal_mode == "ad"
        m = motion.clone().requires_grad_(ad)
        hc = color.flip(-1).contiguous().requires_grad_(ad)
        g = GBuffer(render=color, albedo=torch.full_like(color, 0.7),
                    normal=normal, depth=depth, motion=m)
        h = History(color=hc, moments=torch.stack([var, var * 2]),
                    length=torch.floor(var * 300), prev_depth=depth,
                    prev_normal=normal)
        before = (clamped_gather_cuda.launches,
                  clamped_gather_bwd_cuda.launches,
                  history_stack_channel_minor_cuda.launches)
        out, _ = svgf_denoise_frame(g, h, params=params, impl=impl,
                                    temporal=temporal_mode)
        outs.append(out.denoised)
        if ad:
            grads.append(torch.autograd.grad((out.denoised ** 2).mean(),
                                             (hc, m)))
        if impl == "auto":
            assert clamped_gather_cuda.launches == before[0] + 1
            assert clamped_gather_bwd_cuda.launches == before[1] + int(ad)
            # the history stacked channel-minor by KGp once, so that the
            # wrappers lay nothing out again (they would launch KGp for a
            # planar stack)
            assert history_stack_channel_minor_cuda.launches == before[2] + 1
    a, b = _np(outs[0]), _np(outs[1])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())
    for x, y in zip(*grads):
        np.testing.assert_allclose(_np(x), _np(y), rtol=0,
                                   atol=3e-3 * float(y.abs().max()))


@pytest.mark.parametrize("layout", ["planar", "channel-minor"])
def test_clamped_gather_adjoint_is_repeatable(dev, layout):
    """KGb 20 times on ``test_clamped_gather_and_adjoint_match_plain``'s
    ``outside`` inputs (motion to ±40 pixels: border texels take hundreds
    of addends): every ``d_stack`` within one float32 ulp of the first run's
    or equal to it (the float64 scratch is rounded once; the atomics' order
    moves the float64 sum by ~1e-16 of it), ``d_motion`` bit-equal (a
    gather, no atomics); on a planar and a channel-minor stack."""
    rng = np.random.default_rng(31)
    stack = _stack_in(torch.from_numpy(
        rng.random((10, H, W), dtype=np.float32)).to(dev), layout)
    motion = torch.from_numpy(((rng.random((2, H, W)) - 0.5) * 80.0)
                              .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((10, H, W)).astype(
        np.float32)).to(dev)
    g[temporal.GRAD_PLANES:] = 0
    first = clamped_gather_bwd_cuda(stack, motion, g)
    for run in range(1, 20):
        d_stack, d_motion = clamped_gather_bwd_cuda(stack, motion, g)
        ulps = (d_stack.view(torch.int32).long()
                - first[0].view(torch.int32).long()).abs()
        ok = (d_stack == first[0]) | (ulps <= 1)
        assert bool(ok.all()), (run, int((~ok).sum()))
        assert torch.equal(d_motion, first[1]), run


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=["37x53", "20x20"])
def test_k14_every_level_whole_and_tiles(dev, shape, radius):
    """K14 at levels 0-4 against its plain twin (atol 1e-5·max), whole
    frame and on 2x2 tiles with the margin gradients (out_halo = the
    level's reach r·2^level); the tiles' outputs summed over the canvas
    equal the whole frame's at rtol 1e-5 (the margins' sums in another
    order)."""
    _check_k14_levels(dev, shape, radius, range(5))


@pytest.mark.parametrize("level", [5, 6])
def test_k14_radius2_wide_spacing(dev, level):
    """K14 at radius 2 on a 150x170 frame at spacing 32 (its largest
    staged tile) and 64 (the centres read through the caches), as
    ``test_k14_every_level_whole_and_tiles``."""
    _check_k14_levels(dev, (150, 170), 2, (level,))


def _check_k14_levels(dev, shape, radius, levels):
    color, var, normal, depth = _planes(dev, 130 + radius, *shape)
    zg = finite_diff_gradients(depth)
    params = SVGFParams(radius=radius)
    sd = atrous.sigma_denominator(var, params)
    g = torch.Generator(dev).manual_seed(30 + radius)
    gc = torch.randn((3, *shape), generator=g, device=dev)
    gv = torch.randn(shape, generator=g, device=dev)
    Hs, Ws = shape
    for level in levels:
        kw = dict(level=level, params=params)
        norm = atrous_level_fwd_cuda(color, var, normal, depth, zg, sd,
                                     **kw)[2]
        before = atrous_level_bwd_cuda.launches
        whole = atrous_level_bwd_cuda(color, normal, depth, zg, sd, norm, gc,
                                      gv, **kw)
        assert atrous_level_bwd_cuda.launches == before + 1
        for a, b in zip(whole, atrous.atrous_level_bwd_ref(
                color, normal, depth, zg, sd, norm, gc, gv, **kw)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=1e-5 * float(b.abs().max()))
        h = radius << level
        acc = [torch.zeros((3, Hs + 2 * h, Ws + 2 * h), device=dev),
               torch.zeros((Hs + 2 * h, Ws + 2 * h), device=dev)]
        for tile, th, tw in _quarter_tiles(shape):
            cc, nc, dc = (frame_canvas(x, tile, th, tw, max(h, 1))
                          for x in (color, normal, depth))
            gy, gx = tile.origin
            zg_t, sd_t, n_t, gc_t, gv_t = (
                x[..., gy:gy + th, gx:gx + tw].contiguous()
                for x in (zg, sd, norm, gc, gv))
            args = (cc, nc, dc, zg_t, sd_t, n_t, gc_t, gv_t)
            got = atrous_level_bwd_cuda(*args, tile=tile, out_halo=h, **kw)
            want = atrous.atrous_level_bwd_ref(*args, tile=tile, out_halo=h,
                                               **kw)
            for a, b, sum_ in zip(got, want, acc):
                np.testing.assert_allclose(
                    _np(a), _np(b), rtol=0,
                    atol=1e-5 * max(float(b.abs().max()), 1e-30))
                sum_[..., gy:gy + th + 2 * h, gx:gx + tw + 2 * h] += a
        for sum_, w in zip(acc, whole):
            np.testing.assert_allclose(
                _np(sum_[..., h:h + Hs, h:h + Ws]), _np(w), rtol=1e-5,
                atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("omega", [1.0, 1.5])
@pytest.mark.parametrize("scene_name,key", SHADE_SCENES,
                         ids=[s[0] for s in SHADE_SCENES])
def test_k8_instantiations_match_plain(dev, scene_name, key, omega):
    """K8 in each instantiation, with and without the previous camera, on
    the whole frame and on a window (the sharded path's launch), against
    ``raymarch.shadow_shade`` on the same inputs: render and motion atol
    1e-4 outside visibility flips (at most 0.1 %), as
    ``test_k7_k8_match_plain``; the window bit-equal to the whole frame's
    crop; each launch counted under the scene's key."""
    scene = _shade_scene(scene_name, dev)
    assert scene_key(scene) == key
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams(relax_omega=omega)
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
    t, hit, mat, n = raymarch.march_gbuf(scene, ro, rd, rm)
    alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.float()[None]
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(0),
                               (H, W))
    planes = (ro + t[None] * rd, n, lp, alb * hit_f, em * hit_f, hit)
    light = raymarch.light_constants(scene)
    prev = raymarch.prev_camera_constants(orbit_camera(0.1875, device=dev),
                                          cfg)
    for prev_c in (prev, None):
        whole = None
        for y0, x0 in ((0, 0), (H // 2, W // 3)):
            win = [x[..., y0:, x0:].contiguous() for x in planes]
            args = (scene, *win, light, prev_c, rm, (W, H), (y0, x0))
            before = shadow_shade_cuda.by_key[key]
            got = shadow_shade_cuda(*args)
            assert shadow_shade_cuda.by_key[key] == before + 1
            want = raymarch.shadow_shade(*args)
            same = got[1] == want[1]
            assert float((~same).float().mean()) <= 1e-3, int((~same).sum())
            np.testing.assert_allclose(_np(got[0])[:, _np(same)],
                                       _np(want[0])[:, _np(same)], rtol=0,
                                       atol=1e-4)
            assert (got[2] is None) == (prev_c is None)
            if prev_c is not None:
                np.testing.assert_allclose(_np(got[2]), _np(want[2]),
                                           rtol=0, atol=1e-4)
            if whole is None:
                whole = got
                continue
            for a, b in zip(got, whole):
                if a is not None:
                    assert torch.equal(a, b[..., y0:, x0:])


# K7's compiled scenes, with the key each runs
MARCH_SCENES = [("cornell", 1), ("random", 2)]


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("scene_name,key", MARCH_SCENES,
                         ids=[s[0] for s in MARCH_SCENES])
def test_k7_compiled_scene_matches_runtime_counts(dev, scene_name, key,
                                                  omega, seeded):
    """K7 in the instantiation compiled for the scene (through the public
    wrappers, counted under its key) is ``torch.equal`` to the runtime-
    count instantiation on the same rays and seed grid, in t, hit,
    material and normal."""
    scene, cfg, cam, ro, rd = _cone_inputs(dev, scene_name)
    rm = RaymarchParams(relax_omega=omega, coarse_seed=seeded)
    seed = (cone_seed_cuda(scene, rm, camera=cam, cam_cfg=cfg,
                           shape=(H, W))[0] if seeded else None)
    wrapper = march_gbuf_seeded_cuda if seeded else march_gbuf_cuda
    assert scene_key(scene) == key
    before = wrapper.by_key[key]
    got = (march_gbuf_seeded_cuda(scene, ro, rd, seed, rm) if seeded
           else march_gbuf_cuda(scene, ro, rd, rm))
    assert wrapper.by_key[key] == before + 1
    runtime, ran = raymarch_cuda._march_launch(scene, ro, rd, rm, seed,
                                               key=0)
    assert ran == 0
    for name, a, b in zip(("t", "hit", "mat", "normal"), got, runtime):
        assert torch.equal(a, b), name


def test_k7_other_counts_run_the_runtime_instantiation(dev):
    """A scene of other counts runs key 0 and matches the twin at K7's
    tolerance; a compiled key given other counts raises (never falls back
    to another instantiation)."""
    scene = _shade_scene("odd", dev)
    assert scene_key(scene) == 0
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    ro, rd, _ = raymarch.camera_rays(orbit_camera(0.25, device=dev), cfg)
    before = march_gbuf_cuda.by_key[0]
    got = march_gbuf_cuda(scene, ro, rd, rm)
    assert march_gbuf_cuda.by_key[0] == before + 1
    want = raymarch.march_gbuf(scene, ro, rd, rm)
    same = (got[1] == want[1]) & (got[2] == want[2])
    assert float((~same).float().mean()) <= 1e-3
    np.testing.assert_allclose(_np(got[0])[_np(same)],
                               _np(want[0])[_np(same)], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(got[3])[:, _np(same)],
                               _np(want[3])[:, _np(same)], rtol=5e-3,
                               atol=5e-4)
    for key in (1, 2):
        with pytest.raises(RuntimeError, match="rdt_march"):
            raymarch_cuda._march_launch(scene, ro, rd, rm, None, key=key)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tile"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["K2", "K2b"])
@pytest.mark.parametrize("radius", RADII)
def test_k2_bit_equal_to_twin(dev, radius, dtype, tiled):
    """K2 (bf16 weights) and K2b (float weights) at every level 0-4, on
    a frame that is no multiple of the row-lattice tile and on one whose
    every tap reach at level 4 leaves it, whole frame and tile form (the
    output region's margins): ``torch.equal`` to
    ``atrous_level_bwd_stored_ref``."""
    for shape in LEVEL_SHAPES:
        g = torch.Generator(dev).manual_seed(30 + radius)
        taps = (2 * radius + 1) ** 2
        w = torch.rand((taps, *shape), generator=g, device=dev).to(dtype)
        norm = 0.2 + 2.0 * torch.rand(shape, generator=g, device=dev)
        gc = torch.randn((3, *shape), generator=g, device=dev)
        gv = torch.randn(shape, generator=g, device=dev)
        for level in range(5):
            kw = dict(level=level, radius=radius,
                      out_halo=(radius << level) if tiled else 0)
            got = atrous_level_bwd_stored_cuda(w, norm, gc, gv, **kw)
            want = atrous.atrous_level_bwd_stored_ref(w, norm, gc, gv, **kw)
            for name, a, b in zip(("d_color", "d_variance"), got, want):
                assert torch.equal(a, b), (shape, level, name)


def _stream_scene_inputs(scene, ro, rd, rm, cfg, dev):
    """K8's and K13's inputs on ``scene``'s G-buffer (the plain march)."""
    H_, W_ = ro.shape[-2:]
    t, hit, mat, n = raymarch.march_gbuf(scene, ro, rd, rm)
    alb, em = raymarch._material_lookup(mat, scene.materials.albedo,
                                        scene.materials.emission)
    hit_f = hit.float()[None]
    lp = raymarch.sample_light(scene, torch.Generator(dev).manual_seed(4),
                               (H_, W_))
    return (ro + t[None] * rd, n, lp, alb * hit_f, em * hit_f, hit,
            raymarch.light_constants(scene),
            raymarch.prev_camera_constants(orbit_camera(0.1875, device=dev),
                                           cfg))


def test_compiled_scene_launches_on_concurrent_streams(dev):
    """The compiled scene's constant buffer (``c_scene``, one a device) is
    filled before every K7, K8, K13 and K15 launch on a compiled scene.
    Two scenes of the Cornell box's counts that differ in one sphere: a
    first stream queues two 1080p K7 launches on one scene, which hold
    every SM for ~0.6 ms; a second stream then launches K7, K8, K13 or
    K15 (from the camera) on the other scene, whose kernel waits for SMs
    after its fill, and a third stream the same kernel on the first scene,
    whose fill would land in that wait.  Each round runs both ways round;
    every output is ``torch.equal`` to the same launch alone on one
    stream: no kernel reads another launch's scene."""
    a = raymarch.cornell_scene(device=dev)
    b = dataclasses.replace(a, sphere_params=torch.tensor(
        [[0.1, -0.65, 0.9, 0.35]], device=dev))
    scenes = dict(a=a, b=b)
    assert scene_key(a) == scene_key(b) == 1
    Hs, Ws = 1080, 1920
    cfg = CameraParams(width=Ws, height=Hs)
    rm, seeded = RaymarchParams(), RaymarchParams(coarse_seed=True)
    cam = orbit_camera(0.25, device=dev)
    ro, rd, _ = raymarch.camera_rays(cam, cfg)
    with torch.no_grad():
        ins = {k: _stream_scene_inputs(s, ro, rd, rm, cfg, dev)
               for k, s in scenes.items()}

        def k7(k):
            return tuple(march_gbuf_cuda(scenes[k], ro, rd, rm))

        def k8(k):
            return tuple(shadow_shade_cuda(scenes[k], *ins[k], rm,
                                           (Ws, Hs)))

        def k13(k):
            return (shadow_factor_cuda(scenes[k], *ins[k][:3], rm),)

        def k15(k):
            return tuple(cone_seed_cuda(scenes[k], seeded, camera=cam,
                                        cam_cfg=cfg, shape=(Hs, Ws)))

        kernels = dict(K7=k7, K8=k8, K13=k13, K15=k15)
        alone = {(name, k): fn(k) for name, fn in kernels.items()
                 for k in scenes}
        for name in kernels:
            assert not all(torch.equal(x, y) for x, y in zip(
                alone[name, "a"], alone[name, "b"])), name
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream() for _ in range(3)]
        for name, fn in kernels.items():
            for x, y in (("a", "b"), ("b", "a")):
                for s in streams:
                    s.wait_stream(torch.cuda.current_stream())
                outs = []
                for s, k, launch in ((streams[0], x, k7),
                                     (streams[0], x, k7),
                                     (streams[1], y, fn),
                                     (streams[2], x, fn)):
                    with torch.cuda.stream(s):
                        outs.append((launch, k, launch(k)))
                torch.cuda.synchronize()
                for j, (launch, k, out) in enumerate(outs):
                    want = alone[launch.__name__.upper(), k]
                    for u, v in zip(out, want):
                        assert torch.equal(u, v), (name, x, j)
