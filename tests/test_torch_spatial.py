"""The port's à-trous sweep (K1's plain version, reached through its
wrapper on CPU tensors) against the JAX package.

Tolerances:
* exact weights vs ``svgf_spatial_ref`` (jnp oracle, detached weights):
  rtol 5e-5 — both are float32 with the same operation order; the residue
  is exp/pow/reduction rounding across libraries.
* fast weights vs ``svgf_spatial_pallas(interpret=True, weight_math="fast",
  bwd_impl="none")`` (the TPU kernel, interpreted): atol 2e-4·max|ref|, the
  JAX package's own fast-vs-exact bound — the kernel's Newton reciprocals
  differ from true division by an ulp, which moves the degree-3 exp across
  its range-reduction seams.
* the CUDA kernel vs the plain version (``tests/test_torch_cuda.py``, on
  the card): the same rtol 5e-5 for exact weights, atol 2e-4·max for fast.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.ops.atrous import (
    svgf_spatial_ref as j_svgf_spatial_ref,
    variance_blur3x3 as j_variance_blur3x3)
from raymarchdenoisercuda_tpu.ops.common import (
    finite_diff_gradients as j_finite_diff_gradients, shift2d as j_shift2d,
    tap_offsets as j_tap_offsets)
from raymarchdenoisercuda_tpu.ops.pallas.atrous_tpu import svgf_spatial_pallas
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.ops import atrous, common
from raymarchdenoisercuda_torch.ops.atrous_cuda import svgf_spatial_cuda

H, W = 32, 48


def _planes(seed, H=H, W=W):
    rng = np.random.default_rng(seed)
    color = rng.random((3, H, W), dtype=np.float32)
    variance = (0.02 * rng.random((H, W))).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    return color, variance, n, depth


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -3), (-5, 1), (40, 0)])
def test_common_helpers_match(dy, dx):
    x = np.random.default_rng(1).random((3, 9, 11), dtype=np.float32)
    np.testing.assert_array_equal(
        common.shift2d(torch.from_numpy(x), dy, dx).numpy(),
        np.asarray(j_shift2d(jnp.asarray(x), dy, dx)))
    z = x[0]
    np.testing.assert_array_equal(
        common.finite_diff_gradients(torch.from_numpy(z)).numpy(),
        np.asarray(j_finite_diff_gradients(jnp.asarray(z))))
    np.testing.assert_allclose(
        atrous.variance_blur3x3(torch.from_numpy(z)).numpy(),
        np.asarray(j_variance_blur3x3(jnp.asarray(z))), rtol=1e-6)
    assert common.tap_offsets(2, 4) == j_tap_offsets(2, 4)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("luma_only_from", [None, 3])
def test_spatial_exact_matches_jnp_oracle(radius, luma_only_from):
    color, variance, normal, depth = _planes(radius)
    kw = dict(radius=radius, luma_only_from=luma_only_from)
    want = j_svgf_spatial_ref(color, variance, normal, depth,
                              params=JSVGFParams(**kw), detach_weights=True,
                              return_feedback=True)
    got = svgf_spatial_cuda(*_t(color, variance, normal, depth),
                            params=SVGFParams(**kw), weight_math="exact",
                            return_feedback=True)
    for name, a, b in zip(("color", "variance", "feedback"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("radius", [1, 2])
def test_spatial_fast_matches_pallas_kernel(radius):
    # interpret mode is slow: a smaller frame than the other tests
    color, variance, normal, depth = _planes(10 + radius, 24, 40)
    want = svgf_spatial_pallas(
        *map(jnp.asarray, (color, variance, normal, depth)),
        params=JSVGFParams(radius=radius), interpret=True,
        weight_math="fast", bwd_impl="none", return_feedback=True)
    got = svgf_spatial_cuda(*_t(color, variance, normal, depth),
                            params=SVGFParams(radius=radius),
                            weight_math="fast", return_feedback=True)
    for name, a, b in zip(("color", "variance", "feedback"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-4 * np.abs(b).max(), err_msg=name)


def test_spatial_wrapper_rejects_unknown_weight_math():
    planes = _t(*_planes(0, 8, 8))
    with pytest.raises(ValueError, match="weight_math"):
        svgf_spatial_cuda(*planes, weight_math="approx")


def test_spatial_two_outputs_without_feedback():
    c, v = svgf_spatial_cuda(*_t(*_planes(0, 8, 8)),
                             params=SVGFParams(iterations=2))
    assert c.shape == (3, 8, 8) and v.shape == (8, 8)
