"""``precision="bf16"``: the plain twins of K1b's and K14's bfloat16 forms
(``ops/atrous.py``) against the JAX package's Pallas kernels in interpret
mode, one level at a time, and the mode's validation
(``tests/test_torch_bf16_sweep.py`` holds the sweep and the denoiser).

The bf16 mode has no jnp oracle: the twins follow the Pallas body
(``_make_level_kernel`` with ``dtype=jnp.bfloat16``) operation by
operation, each rounded to bfloat16 where the interpret-mode kernel rounds
it.  Measured on this CPU (XLA:CPU): the interpret-mode kernel keeps each
weight-times-value product that feeds a float32 sum unrounded (XLA drops
the bf16 round trip between the product and the float32 add), and N adds
the weight unrounded too; the twins do the same.

Tolerances, relative to the compared plane's max|·|:

* K14's twin (the adjoint) against ``atrous_level_bwd_pallas(interpret=
  True, precision="bf16")``: measured bit-equal on every case; held at
  atol 2^-20·max, which leaves room only for the subnormal weights that
  XLA:CPU flushes to zero and the twin keeps (products below 1e-38).
* K1b's twin (the level forward) against ``atrous_level_fwd_pallas(...,
  precision="bf16")``: c, v and N at atol 2^-9·max, and at most 1 % of
  the elements beyond 2^-12·max.  The kernel divides by a Newton step
  from a bf16 reciprocal (``_recip``: ~2^-16 relative, twice that for v's
  1/N²) where the twin and the CUDA kernel take a true float32 division:
  measured c ≤ 1.5e-5·max, v ≤ 3.1e-5·max, N bit-equal, on 16 cases of
  r1/r2, levels 0/1, five shapes.  Now and then the depth scale rz, so
  divided, lands on the other side of a bf16 rounding: one tap's weight
  moves by a bf16 step, and that pixel's c, v and N by up to 4.8e-4·max
  (measured: one pixel of 703, on one of those cases).  The bound is four
  times inside the 2^-7·max a level that bfloat16's own step allows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.ops.atrous import variance_blur3x3
from raymarchdenoisercuda_tpu.ops.common import (
    finite_diff_gradients as j_zgrad)
from raymarchdenoisercuda_tpu.ops.pallas.atrous_tpu import (
    atrous_level_bwd_pallas, atrous_level_fwd_pallas)
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.ops import atrous
from raymarchdenoisercuda_torch.ops.atrous_cuda import (
    atrous_level_bwd_cuda, atrous_level_fwd_cuda, svgf_spatial_ad_cuda)
from raymarchdenoisercuda_torch.ops.common import Tile


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


def _far_share(got, want, rel):
    """The share of elements farther apart than rel·max|want|."""
    want = np.asarray(want, np.float64)
    d = np.abs(got.double().numpy() - want)
    return float(np.mean(d > rel * np.abs(want).max()))


@pytest.mark.parametrize("radius,level,shape", [
    (1, 0, (19, 37)), (1, 1, (21, 35)), (2, 0, (21, 35)), (2, 1, (19, 37))])
def test_level_twins_match_interpret_kernels(radius, level, shape):
    c, v, n, z, gc, gv = _planes(100 * radius + 10 * level, *shape)
    jp = JSVGFParams(radius=radius)
    zg = np.asarray(j_zgrad(jnp.asarray(z)))
    sd = np.asarray(jp.sigma_color * jnp.sqrt(jnp.maximum(
        variance_blur3x3(jnp.asarray(v)), 0.0)) + 1e-8)
    jc, jv, jn = atrous_level_fwd_pallas(
        *map(jnp.asarray, (c, v, n, z, zg, sd)), level=level, params=jp,
        interpret=True, precision="bf16")
    tc, tv, tn = atrous_level_fwd_cuda(
        *map(_t, (c, v, n, z, zg, sd)), level=level,
        params=SVGFParams(radius=radius), precision="bf16")
    for got, want in ((tc, jc), (tv, jv), (tn, jn)):
        assert _rel_err(got, want) <= 2.0 ** -9
        assert _far_share(got, want, 2.0 ** -12) <= 0.01
    # the adjoint at the kernel's own N, so both read the same inputs
    jdc, jdv = atrous_level_bwd_pallas(
        *map(jnp.asarray, (c, n, z, zg, sd, np.asarray(jn), gc, gv)),
        level=level, params=jp, interpret=True, precision="bf16")
    tdc, tdv = atrous_level_bwd_cuda(
        *map(_t, (c, n, z, zg, sd, jn, gc, gv)), level=level,
        params=SVGFParams(radius=radius), precision="bf16")
    assert _rel_err(tdc, jdc) <= 2.0 ** -20
    assert _rel_err(tdv, jdv) <= 2.0 ** -20


def test_exp2_bf16_matches_its_definition():
    """2^y to bf16 precision over the clamp's range, exact powers of two at
    integers, and the clamp."""
    k = atrous._bf16_tensors(SVGFParams(), "cpu")
    y = torch.linspace(-130.0, 0.0, 20001).to(torch.bfloat16)
    got = atrous.exp2_fast_bf16(y, k).double()
    want = torch.exp2(y.double())
    ok = want >= 2.0 ** -126
    rel = ((got - want).abs() / want)[ok]
    assert float(rel.max()) < 2.0 ** -6
    ints = torch.arange(-126, 1, dtype=torch.float32).to(torch.bfloat16)
    assert torch.equal(atrous.exp2_fast_bf16(ints, k).double(),
                       torch.exp2(ints.double()))
    huge = torch.tensor([-1e30, -1e4], dtype=torch.bfloat16)
    assert torch.equal(atrous.exp2_fast_bf16(huge, k),
                       atrous.exp2_fast_bf16(k["floor"].expand(2), k))


def test_bf16_constants_are_bfloat16_values():
    k = atrous.bf16_constants(SVGFParams(sigma_depth=0.3, sigma_normal=64.0))
    for name, v in k.items():
        assert float(torch.tensor(v, dtype=torch.float64).to(
            torch.bfloat16)) == v, name
    assert k["floor"] == -9984.0 and k["l0"] == 0.212890625
    # JAX rounds a Python constant in a bf16 operation the same way
    for v in (0.2126, 1.0 / 6.0, -1e4, 0.3 * atrous._LN2):
        assert atrous.bf16_round(v) == float(jnp.asarray(v, jnp.bfloat16))


@pytest.mark.parametrize("kw,err,match", [
    (dict(precision="bf16", weight_math="fast"), ValueError, "chained"),
    (dict(precision="bf16", weight_math="fast", bwd_impl="none"), ValueError,
     "chained"),
    (dict(precision="bf16", params=SVGFParams(luma_only_from=2)), ValueError,
     "luma_only_from"),
    (dict(precision="bf16", params=SVGFParams(luma_only_from=2),
          bwd_impl="none"), ValueError, "luma_only_from"),
    (dict(precision="f16"), ValueError, "precision"),
])
def test_bf16_validation_raises(kw, err, match):
    c, v, n, z = (_t(a) for a in _planes(45, 8, 8)[:4])
    with pytest.raises(err, match=match):
        svgf_spatial_ad_cuda(c, v, n, z, **kw)


def test_bf16_level_validation_raises():
    c, v, n, z, gc, gv = (_t(a) for a in _planes(46, 8, 8))
    zg = atrous.finite_diff_gradients(z)
    sd = atrous.sigma_denominator(v, SVGFParams())
    with pytest.raises(ValueError, match="bf16"):
        atrous.atrous_level_ref(c, v, n, z, zg, precision="bf16")
    with pytest.raises(ValueError, match="bf16"):
        atrous.atrous_level_ref(c, v, n, z, zg, sigma_denom=sd,
                                weight_math="fast", precision="bf16")
    with pytest.raises(ValueError, match="bf16"):
        atrous_level_fwd_cuda(c, v, n, z, zg, sd, level=0,
                              params=SVGFParams(), precision="bf16",
                              tile=Tile((0, 0), (8, 8)))
    with pytest.raises(ValueError, match="bf16"):
        atrous_level_bwd_cuda(c, n, z, zg, sd, sd, gc, gv, level=0,
                              params=SVGFParams(), precision="bf16",
                              out_halo=1)
    g = GBuffer(render=c, albedo=c, normal=n, depth=z,
                motion=torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="precision"):
        svgf_denoise_frame(g, History.zeros(8, 8, device="cpu"),
                           precision="f16")
