"""Gradients of the port's temporal step against ``jax.grad`` of the JAX
package's.

Tolerance: rtol 1e-5, atol 1e-6 on every gradient — the JAX package's own
bound for its differentiable kernel against the oracle
(``tests/test_temporal.py``); the sums run in another order, so the residue
is rounding only.  The motion gradient is checked at zero, integer and
fractional motion: at integer motion the tent's kinks decide it, and
autograd of ``max(0, 1 − |x|)`` (tent'(0) = 0, tent'(±1) = ∓1) differs from
JAX's convention (−1 and ∓0.5), which the port's written-out adjoint
follows.  The CUDA kernels K4-K6 are held to these plain versions on the
card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.ops.pallas.temporal_tpu import (
    _tent_prime as j_tent_prime)
from raymarchdenoisercuda_tpu.ops.temporal import (
    bilinear_shift_sample_many as j_shift_sample,
    temporal_accumulate as j_temporal_accumulate)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.ops import common, temporal, temporal_cuda
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    temporal_accumulate_ad_cuda, temporal_accumulate_cuda)

H, W = 32, 40
TOL = dict(rtol=1e-5, atol=1e-6)
MOTIONS = {
    "zero": lambda rng: np.zeros((2, H, W)),
    "integer": lambda rng: np.round((rng.random((2, H, W)) - 0.5) * 8),
    "fractional": lambda rng: (rng.random((2, H, W)) - 0.5) * 8,
}
NAMES = ("d_render", "d_hist_color", "d_hist_moments", "d_hist_length",
         "d_motion")


def _inputs(seed, motion):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 2.5
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.5 + rng.random((H, W))).astype(np.float32)
    g = dict(render=rng.random((3, H, W), dtype=np.float32),
             albedo=np.full((3, H, W), 0.7, np.float32), normal=n,
             depth=depth, motion=MOTIONS[motion](rng).astype(np.float32))
    # lengths 0-5: prev_len 4 makes 1/n_new tie with temporal_alpha = 0.2
    h = dict(color=rng.random((3, H, W), dtype=np.float32),
             moments=rng.random((2, H, W), dtype=np.float32),
             length=np.floor(rng.random((H, W)) * 6).astype(np.float32),
             prev_depth=depth, prev_normal=n)
    return g, h


def _loss(i, v, nh):
    return ((i ** 2).sum() + (v * 1.3).sum() + (nh.moments * 0.3).sum()
            + (nh.length * 0.1).sum())


def _jax_grads(g, h):
    def loss(render, hc, hm, hl, mot):
        gg = JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}).replace(
            render=render, motion=mot)
        hh = JHistory(**{k: jnp.asarray(v) for k, v in h.items()}).replace(
            color=hc, moments=hm, length=hl)
        return _loss(*j_temporal_accumulate(gg, hh, params=JSVGFParams()))

    args = [jnp.asarray(x) for x in (g["render"], h["color"], h["moments"],
                                     h["length"], g["motion"])]
    return [np.asarray(x) for x in jax.grad(loss, argnums=range(5))(*args)]


def _torch_run(fn, g, h, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (
        g["render"], h["color"], h["moments"], h["length"], g["motion"])]
    gb = convert.gbuffer_from_numpy(g, "cpu").replace(render=leaves[0],
                                                      motion=leaves[4])
    hb = convert.history_from_numpy(h, "cpu").replace(
        color=leaves[1], moments=leaves[2], length=leaves[3])
    out = fn(gb, hb, params=SVGFParams(), **kw)
    grads = torch.autograd.grad(_loss(*out), leaves, allow_unused=True)
    return out, [None if x is None else x.numpy() for x in grads]


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_temporal_gradients_match_jax(motion):
    g, h = _inputs(1, motion)
    want = _jax_grads(g, h)
    _, got = _torch_run(temporal.temporal_accumulate, g, h)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
        assert np.abs(b).max() > 0, f"{name} trivially zero"


@pytest.mark.parametrize("motion", ["integer", "fractional"])
def test_temporal_ad_matches_temporal_accumulate(motion):
    """The training step's temporal path (6 gradient planes): the values of
    ``temporal_accumulate`` exactly, its gradients, and with
    ``motion_grad=False`` no motion gradient.  On CPU tensors the CUDA
    entry point runs the same plain twins."""
    g, h = _inputs(2, motion)
    ref, want = _torch_run(temporal.temporal_accumulate, g, h)
    for fn in (temporal.temporal_accumulate_ad, temporal_accumulate_ad_cuda):
        out, got = _torch_run(fn, g, h)
        for a, b in zip((out[0], out[1], out[2].moments, out[2].length),
                        (ref[0], ref[1], ref[2].moments, ref[2].length)):
            assert torch.equal(a, b)
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)
        _, got = _torch_run(fn, g, h, motion_grad=False)
        assert got[4] is None
        for name, a, b in zip(NAMES[:4], got, want):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def _gather_motion(kind, rng, M, H, W):
    """Motion of the reprojection's parity cases: inside ±M ("integer",
    "fractional"); a smooth, coherent field (a camera's: floors shared by
    neighbours); a third of the pixels exactly at ±M or ±(M + 1) on either
    axis ("at M and M+1"); uniform to ±(M + 1), some pixels beyond M
    ("beyond M")."""
    m = (rng.random((2, H, W)) - 0.5)
    if kind == "integer":
        m = np.round(m * (2 * M + 1))
    elif kind == "fractional":
        m = m * 2 * M
    elif kind == "smooth":
        iy, ix = np.mgrid[0:H, 0:W]
        m = np.stack([0.9 * M * np.sin(0.21 * ix + 0.1 * iy) - 0.35,
                      0.6 * M * np.cos(0.17 * iy) + 0.03 * ix - 0.6])
    elif kind == "at M and M+1":
        edge = rng.choice([-M - 1.0, -M, M, M + 1.0], size=(2, H, W))
        m = np.where(rng.random((2, H, W)) < 1 / 3, edge, m * 2 * M)
    else:
        m = m * 2 * (M + 1)
    return m.astype(np.float32)


@pytest.mark.parametrize("motion", ["integer", "fractional", "smooth",
                                    "at M and M+1", "beyond M"])
def test_reproject_gather_vjp_matches_jax(motion):
    """The reprojection alone, for an arbitrary cotangent, against the VJP
    of the JAX package's ``bilinear_shift_sample_many`` with its samples
    beyond ±M zeroed by its ``within`` mask (the port's bounded gather
    reads zero there), on the motions whose floor ranges the card's
    adjoint reduces per block: a smooth field, motion exactly at ±M and
    ±(M + 1), and pixels beyond M."""
    M = 2
    rng = np.random.default_rng(3)
    stack = rng.random((10, 12, 16), dtype=np.float32)
    mot = _gather_motion(motion, rng, M, 12, 16)
    cot = rng.standard_normal((10, 12, 16)).astype(np.float32)

    def bounded(s, m):
        (out,), within = j_shift_sample([s], m, M)
        return jnp.where(within[None], out, 0.0)

    out, vjp = jax.vjp(jax.jit(bounded), jnp.asarray(stack),
                       jnp.asarray(mot))
    want = vjp(jnp.asarray(cot))
    s, m = (torch.from_numpy(x).requires_grad_() for x in (stack, mot))
    got_out = temporal.reproject_gather(s, m, M)
    got = torch.autograd.grad(got_out, (s, m), torch.from_numpy(cot))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **TOL)
    for name, a, b in zip(("d_stack", "d_motion"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        assert np.abs(np.asarray(b)).max() > 0, f"{name} trivially zero"


def test_tent_prime_matches_jax():
    x = np.asarray([-2.0, -1.0, -0.75, -0.0, 0.0, 0.25, 1.0, 1.5],
                   np.float32)
    np.testing.assert_array_equal(
        common.tent_prime(torch.from_numpy(x)).numpy(),
        np.asarray(j_tent_prime(jnp.asarray(x))))


def test_fused_step_refuses_gradients():
    g, h = _inputs(4, "fractional")
    gb = convert.gbuffer_from_numpy(g, "cpu")
    hb = convert.history_from_numpy(h, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        temporal_accumulate_cuda(gb.replace(render=gb.render.requires_grad_()),
                                 hb)


# -- the fused route of the training step: K3 and its adjoint K16 ------------
#
# On CPU tensors the route's Function runs the plain step forward and
# ``temporal_step_bwd_ref`` (K16's plain twin, which the card holds K16 to
# bit for bit) backward.

FUSED_NODE = "_FusedTemporalStepBackward"


def _route_inputs(seed, history):
    """Temporal inputs with invalid pixels (a depth jump, a flipped
    normal, motion out of the frame at its borders) and history lengths
    0-7 ("mixed": both sides of a boost of 4) or 5-9 ("long": none short
    but the invalid pixels)."""
    g, h = _inputs(seed, "fractional")
    rng = np.random.default_rng(seed + 100)
    lo, hi = (0, 8) if history == "mixed" else (5, 10)
    h["length"] = rng.integers(lo, hi, (H, W)).astype(np.float32)
    h["prev_depth"] = h["prev_depth"].copy()
    h["prev_depth"][rng.random((H, W)) < 0.1] *= 1.5
    h["prev_normal"] = h["prev_normal"].copy()
    h["prev_normal"][:, rng.random((H, W)) < 0.1] *= -1.0
    return g, h


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((3, H, W), (H, W), (2, H, W))]


def _torch_bwd(g, h, cots, params):
    gb = convert.gbuffer_from_numpy(g, "cpu")
    hb = convert.history_from_numpy(h, "cpu")
    integ, var, nh = temporal.temporal_accumulate(gb, hb, params=params)
    gi, gv, gm = (torch.from_numpy(c) for c in cots)
    return temporal.temporal_step_bwd_ref(gb, hb, nh.moments, nh.length, gi,
                                          gv, gm, params), nh


@pytest.mark.parametrize("history", ["mixed", "long"])
@pytest.mark.parametrize("boost", [4, 0])
@pytest.mark.parametrize("clamp", [True, False])
def test_written_out_adjoint_matches_jax(clamp, boost, history):
    """K16's twin against ``jax.grad`` of the JAX package's step with
    respect to the render, for random cotangents of integrated, variance
    and the new moments."""
    g, h = _route_inputs(6, history)
    cots = _cotangents(7)
    jp = JSVGFParams(history_clamp=clamp, variance_boost_frames=boost)

    def loss(render):
        gg = JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}).replace(
            render=render)
        hh = JHistory(**{k: jnp.asarray(v) for k, v in h.items()})
        i, v, nh = j_temporal_accumulate(gg, hh, params=jp)
        return ((i * cots[0]).sum() + (v * cots[1]).sum()
                + (nh.moments * cots[2]).sum())

    want = np.asarray(jax.grad(loss)(jnp.asarray(g["render"])))
    got, nh = _torch_bwd(g, h, cots, SVGFParams(history_clamp=clamp,
                                                variance_boost_frames=boost))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    length = nh.length.numpy()
    assert (length == 1).any(), "no invalid pixel"
    if history == "mixed":
        assert (length < 4).any() and (length >= 4).any()


def _tied_inputs(kind):
    """Frames whose epilogue ties: "flat" patches of one colour, a zero
    background (its 7x7 variance exactly 0) and histories whose colour
    equals the clamp's bounds; "levels" a render of 3 grey levels."""
    g, h = _route_inputs(8, "mixed")
    render = g["render"]
    if kind == "flat":
        render[:, 4:14, 6:16] = 0.25
        render[:, 18:, :12] = 0.0
        h["color"][:, 4:14, 6:16] = 0.25
    else:
        render[:] = np.round(render * 2) / 2
    g["render"] = render
    g["motion"] = np.zeros_like(g["motion"])
    return g, h


@pytest.mark.parametrize("kind", ["flat", "levels"])
@pytest.mark.parametrize("boost", [4, 0])
def test_written_out_adjoint_splits_ties_as_autograd(kind, boost):
    """K16's twin against autograd of the plain epilogue on frames with
    exact ties (the clamp's min/max chain, ``max(·, 0)`` of both
    variances): a tied link halves its cotangent, as
    ``torch.minimum``/``torch.maximum`` do."""
    g, h = _tied_inputs(kind)
    cots = _cotangents(9)
    params = SVGFParams(variance_boost_frames=boost)
    gb = convert.gbuffer_from_numpy(g, "cpu")
    hb = convert.history_from_numpy(h, "cpu")
    render = gb.render.clone().requires_grad_()
    integ, var, nh = temporal.temporal_accumulate(gb.replace(render=render),
                                                  hb, params=params)
    gi, gv, gm = (torch.from_numpy(c) for c in cots)
    want, = torch.autograd.grad((integ * gi).sum() + (var * gv).sum()
                                + (nh.moments * gm).sum(), render)
    got, _ = _torch_bwd(g, h, cots, params)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # ties the chain splits: a pixel whose 3x3 minimum several taps reach
    c = gb.render
    lo = temporal._minmax_stage(temporal._minmax_stage(c, True, True),
                                False, True)
    assert int((temporal.shift2d(c, 0, 1) == lo).logical_and(
        c == lo).sum()) > 0


def _grads_of_route(gb, hb, params, **kw):
    out = temporal_accumulate_ad_cuda(gb, hb, params=params, **kw)
    return out, type(out[0].grad_fn).__name__


def test_fused_route_runs_where_only_the_render_takes_a_gradient():
    """The route: bounded motion, no tile, no history plane and no motion
    that takes a gradient (motion that requires grad under
    ``motion_grad=False`` takes none)."""
    g, h = _route_inputs(10, "mixed")
    gb = convert.gbuffer_from_numpy(g, "cpu")
    hb = convert.history_from_numpy(h, "cpu")
    r = gb.render.clone().requires_grad_()
    m = gb.motion.clone().requires_grad_()
    fused = SVGFParams()
    for kw in (dict(gbuf=gb.replace(render=r)),
               dict(gbuf=gb.replace(render=r, motion=None)),
               dict(gbuf=gb.replace(render=r, motion=m),
                    motion_grad=False)):
        _, node = _grads_of_route(kw.pop("gbuf"), hb, fused, **kw)
        assert node == FUSED_NODE
    # the old route: K4-K6 (or the clamped gather) and the plain epilogue
    old = [_grads_of_route(gb.replace(render=r),
                           hb.replace(color=hb.color.clone()
                                      .requires_grad_()), fused),
           _grads_of_route(gb.replace(render=r, motion=m), hb, fused,
                           motion_grad=True),
           _grads_of_route(gb.replace(render=r), hb,
                           SVGFParams(max_motion=None))]
    for _, node in old:
        assert node != FUSED_NODE
    tile = common.Tile((0, 0), (H, W))
    canvas = common.frame_canvas(temporal.history_stack(hb), tile, H, W, 7)
    gc = gb.replace(render=common.frame_canvas(r, tile, H, W, 3))
    integ, _, _ = temporal_cuda.temporal_accumulate_canvas_ad_cuda(
        gc, canvas, params=fused, tile=tile, motion_grad=False)
    assert type(integ.grad_fn).__name__ != FUSED_NODE


@pytest.mark.parametrize("history", ["mixed", "long"])
def test_fused_route_forward_equals_temporal_accumulate_ad(history):
    """The fused route's values are ``temporal_accumulate_ad``'s, exactly,
    and its render gradient is the old route's within rounding."""
    g, h = _route_inputs(11, history)
    gb = convert.gbuffer_from_numpy(g, "cpu")
    hb = convert.history_from_numpy(h, "cpu")
    outs, grads = [], []
    for fn, kw in ((temporal_accumulate_ad_cuda, {}),
                   (temporal.temporal_accumulate_ad, dict(motion_grad=False))):
        r = gb.render.clone().requires_grad_()
        integ, var, nh = fn(gb.replace(render=r), hb, params=SVGFParams(),
                            **kw)
        outs.append((integ, var, nh.moments, nh.length))
        grads.append(torch.autograd.grad(
            _loss(integ, var, nh), r)[0])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), **TOL)
