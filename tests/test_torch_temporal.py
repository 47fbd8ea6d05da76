"""The port's temporal step (K3's plain version, reached through its wrapper
on CPU tensors) against the JAX package's ``temporal_accumulate``.

Tolerance: rtol 1e-5, atol 1e-6 on the integrated colour, variance and
moments, and the history length exactly — the JAX package's own
kernel-vs-oracle bound (``tests/test_temporal.py``).  The four bilinear taps
accumulate in the reference's order, so the residue is rounding only.  The
CUDA kernel is held to the plain version at the same tolerance on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.ops.temporal import (
    _neighborhood_minmax as j_minmax, spatial_moments as j_spatial_moments,
    temporal_accumulate as j_temporal_accumulate)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import History
from raymarchdenoisercuda_torch.ops import temporal
from raymarchdenoisercuda_torch.ops.temporal_cuda import (
    temporal_accumulate_cuda)

H, W = 40, 48

MOTIONS = {
    "zero": lambda rng: np.zeros((2, H, W), np.float32),
    "uniform_frac": lambda rng: np.stack([np.full((H, W), 1.3),
                                          np.full((H, W), -2.7)]),
    "varying": lambda rng: np.stack(np.broadcast_arrays(
        np.linspace(-5.5, 5.5, H)[:, None], np.linspace(5.5, -5.5, W)[None])),
    "random": lambda rng: (rng.random((2, H, W)) - 0.5) * 8,
    "over_limit": lambda rng: np.stack([np.full((H, W), 7.2),
                                        np.zeros((H, W))]),
    "boundary": lambda rng: np.stack([np.full((H, W), 6.0),
                                      np.full((H, W), -6.5)]),
}


def _inputs(seed, motion_name, H=H, W=W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 2.5
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.5 + rng.random((H, W))).astype(np.float32)
    # half the pixels keep last frame's depth, half move a little or a lot
    prev_depth = depth * np.where(rng.random((H, W)) < 0.5, 1.0,
                                  rng.uniform(0.95, 1.2, (H, W)))
    g = dict(render=rng.random((3, H, W), dtype=np.float32),
             albedo=np.full((3, H, W), 0.7, np.float32), normal=n,
             depth=depth,
             motion=MOTIONS[motion_name](rng).astype(np.float32))
    h = dict(color=rng.random((3, H, W), dtype=np.float32),
             moments=rng.random((2, H, W), dtype=np.float32),
             length=np.floor(rng.random((H, W)) * 6).astype(np.float32),
             prev_depth=prev_depth.astype(np.float32), prev_normal=n)
    return g, h


def _jax(g, h, params):
    jg = JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()})
    jh = JHistory(**{k: jnp.asarray(v) for k, v in h.items()})
    return j_temporal_accumulate(jg, jh, params=params)


def _compare(got, want):
    gi, gv, gh = got
    wi, wv, wh = want
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gi.cpu().numpy(), np.asarray(wi), **tol)
    np.testing.assert_allclose(gv.cpu().numpy(), np.asarray(wv), **tol)
    gh = convert.history_to_numpy(gh)
    np.testing.assert_allclose(gh["color"], np.asarray(wh.color), **tol)
    np.testing.assert_allclose(gh["moments"], np.asarray(wh.moments), **tol)
    np.testing.assert_array_equal(gh["length"], np.asarray(wh.length))
    np.testing.assert_array_equal(gh["prev_depth"], np.asarray(wh.prev_depth))
    np.testing.assert_array_equal(gh["prev_normal"],
                                  np.asarray(wh.prev_normal))


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_temporal_matches_jax(motion):
    g, h = _inputs(3, motion)
    got = temporal_accumulate_cuda(convert.gbuffer_from_numpy(g, "cpu"),
                                   convert.history_from_numpy(h, "cpu"),
                                   params=SVGFParams())
    _compare(got, _jax(g, h, JSVGFParams()))


@pytest.mark.parametrize("kw", [
    dict(variance_boost_frames=0), dict(history_clamp=False),
    dict(max_motion=2, temporal_alpha=0.1), dict(max_motion=None)])
def test_temporal_options_match_jax(kw):
    g, h = _inputs(4, "random")
    got = temporal_accumulate_cuda(convert.gbuffer_from_numpy(g, "cpu"),
                                   convert.history_from_numpy(h, "cpu"),
                                   params=SVGFParams(**kw))
    _compare(got, _jax(g, h, JSVGFParams(**kw)))


def test_temporal_first_frame_from_zero_history():
    g, _ = _inputs(5, "zero")
    zero = History.zeros(H, W, device="cpu")
    got = temporal_accumulate_cuda(convert.gbuffer_from_numpy(g, "cpu"), zero,
                                   params=SVGFParams())
    np.testing.assert_array_equal(got[0].numpy(), g["render"])
    assert float(got[2].length.min()) == 1.0


def test_temporal_helpers_match_jax():
    x = np.random.default_rng(6).random((3, 17, 23), dtype=np.float32)
    lo, hi = temporal._neighborhood_minmax(torch.from_numpy(x))
    jlo, jhi = j_minmax(jnp.asarray(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    for a, b in zip(temporal.spatial_moments(torch.from_numpy(x[0])),
                    j_spatial_moments(jnp.asarray(x[0]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
