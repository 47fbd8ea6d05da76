"""The port's filters (``ops/boxfilter.py``, ``ops/filters.py``; the plain
twins of K10, K11 and K12, reached through their wrappers on CPU tensors)
against the JAX package's, including its Pallas kernels in interpret mode.

Tolerances (the JAX package's own kernel-vs-oracle bounds):
* ``box_filter_u8``: at most 1 apart on under 0.1 % of the pixels, against
  the JAX function and against the C++ oracle of ``native/`` (the float sum
  of a window may land within an ulp of an integer, and the truncating cast
  then goes either way; ``tests/test_boxfilter.py``);
* ``box_filter``: rtol 1e-5, atol 1e-6 (``tests/test_box_pallas.py``);
* ``gaussian_filter``: atol 1e-5 (``test_gaussian_pallas_parity``);
* ``cross_bilateral_filter``: atol 1e-5 against the JAX function (XLA fuses
  multiply-adds and takes ``pow`` its own way), atol 5e-5 against the
  Pallas kernel (base-2 fast exp, repeated squaring;
  ``test_cross_bilateral_pallas_parity``);
* ``apply_filter``: each type at its filter's bound; WAVELET at rtol 5e-5,
  the exact-weight sweep's bound (``tests/test_torch_spatial.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import (
    FilterParams as JFilterParams, FilterType as JFilterType)
from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
from raymarchdenoisercuda_tpu.io import native as jnative
from raymarchdenoisercuda_tpu.ops import boxfilter as jbox
from raymarchdenoisercuda_tpu.ops import filters as jfilters
from raymarchdenoisercuda_tpu.ops.pallas.box_tpu import box_filter_pallas
from raymarchdenoisercuda_tpu.ops.pallas.filters_tpu import (
    cross_bilateral_pallas, gaussian_filter_pallas)
from raymarchdenoisercuda_torch import convert
from raymarchdenoisercuda_torch.config import FilterParams, FilterType
from raymarchdenoisercuda_torch.io import native
from raymarchdenoisercuda_torch.ops import boxfilter, filters
from raymarchdenoisercuda_torch.ops.filters_cuda import (
    box_filter_cuda, cross_bilateral_cuda, gaussian_filter_cuda)

U8_CASES = [(2, 1, False), (2, 1, True), (1, 3, False), (3, 2, True),
            (0, 1, False)]


def _u8_close(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (37, 53, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("radius,depth,quirk", U8_CASES)
def test_box_filter_u8_matches_jax(radius, depth, quirk):
    img = _image(radius + 10 * depth)
    got = boxfilter.box_filter_u8(torch.from_numpy(img), radius, depth, quirk)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    _u8_close(got.numpy(), np.asarray(jbox.box_filter_u8(
        img, radius=radius, depth=depth, grayscale_quirk=quirk)))


@pytest.mark.parametrize("radius,depth,quirk", U8_CASES)
def test_box_filter_u8_matches_native_oracle(radius, depth, quirk):
    if not native.available():
        pytest.skip("native/librdt_native.so not built")
    img = _image(radius + 10 * depth)
    got = boxfilter.box_filter_u8(torch.from_numpy(img), radius, depth, quirk)
    _u8_close(got.numpy(), native.box_filter_u8(img, radius, depth, quirk))
    # the port's binding and the JAX package's call one library
    np.testing.assert_array_equal(
        native.box_filter_u8(img, radius, depth, quirk),
        jnative.box_filter_u8(img, radius, depth, quirk))


@pytest.mark.parametrize("shape,radius,depth", [
    ((3, 40, 48), 2, 1), ((3, 40, 48), 1, 2), ((3, 40, 48), 2, 3),
    ((1, 300, 64), 2, 2)])
def test_box_filter_matches_jax_and_pallas(shape, radius, depth):
    x = np.random.default_rng(radius * depth).random(shape, dtype=np.float32)
    got = box_filter_cuda(torch.from_numpy(x), radius=radius,
                          depth=depth).numpy()
    for want in (jbox.box_filter(x, radius=radius, depth=depth),
                 box_filter_pallas(x, radius=radius, depth=depth,
                                   interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("depth", [1, 2])
def test_gaussian_filter_matches_jax_and_pallas(depth):
    x = np.random.default_rng(3).random((3, 40, 72), dtype=np.float32)
    got = gaussian_filter_cuda(torch.from_numpy(x), radius=2, sigma=2.0,
                               depth=depth).numpy()
    for want in (jfilters.gaussian_filter(x, radius=2, sigma=2.0,
                                          depth=depth),
                 gaussian_filter_pallas(jnp.asarray(x), radius=2, sigma=2.0,
                                        depth=depth, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _guides(seed, H=40, W=72):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return dict(render=rng.random((3, H, W), dtype=np.float32),
                albedo=rng.random((3, H, W), dtype=np.float32), normal=n,
                depth=(0.3 + 0.5 * rng.random((H, W))).astype(np.float32))


@pytest.mark.parametrize("sigma_normal", [128.0, 3.0])
def test_cross_bilateral_matches_jax_and_pallas(sigma_normal):
    g = _guides(4)
    args = (g["render"], g["albedo"], g["normal"], g["depth"])
    got = cross_bilateral_cuda(
        *(torch.from_numpy(a) for a in args),
        params=FilterParams(type=FilterType.CROSS,
                            sigma_normal=sigma_normal)).numpy()
    jp = JFilterParams(type=JFilterType.CROSS, sigma_normal=sigma_normal)
    jargs = tuple(jnp.asarray(a) for a in args)
    np.testing.assert_allclose(
        got, np.asarray(jfilters.cross_bilateral_filter(*jargs, params=jp)),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(cross_bilateral_pallas(*jargs, params=jp,
                                               interpret=True)),
        rtol=0, atol=5e-5)


TOLS = {"average": dict(rtol=1e-5, atol=1e-6),
        "gaussian": dict(rtol=0, atol=1e-5),
        "cross": dict(rtol=0, atol=1e-5),
        "wavelet": dict(rtol=5e-5, atol=1e-7)}


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("ftype,level", [
    ("average", 0), ("gaussian", 0), ("cross", 0), ("wavelet", 0),
    ("wavelet", 1), ("wavelet", 2)])
def test_apply_filter_matches_jax(ftype, level, impl):
    g = _guides(5, 32, 40)
    var = np.full((32, 40), 0.05, np.float32)
    kw = dict(depth=2, radius=2, level=level)
    want = jfilters.apply_filter(
        JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        JFilterParams(type=JFilterType(ftype), **kw), jnp.asarray(var))
    got = filters.apply_filter(
        convert.gbuffer_from_numpy(g, "cpu"),
        FilterParams(type=FilterType(ftype), **kw), torch.from_numpy(var),
        impl=impl)
    assert got.denoised.shape == (3, 32, 40)
    np.testing.assert_allclose(got.denoised.numpy(),
                               np.asarray(want.denoised), **TOLS[ftype])
    np.testing.assert_array_equal(got.render.numpy(), g["render"])


def test_apply_filter_wavelet_without_variance_matches_jax():
    g = _guides(6, 24, 32)
    p = dict(depth=3, radius=1)
    want = jfilters.apply_filter(
        JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        JFilterParams(type=JFilterType.WAVELET, **p))
    got = filters.apply_filter(convert.gbuffer_from_numpy(g, "cpu"),
                               FilterParams(type=FilterType.WAVELET, **p))
    np.testing.assert_allclose(got.denoised.numpy(),
                               np.asarray(want.denoised), **TOLS["wavelet"])


@pytest.mark.parametrize("ftype", ["average", "gaussian", "cross"])
def test_apply_filter_level_rejected_for_non_wavelet(ftype):
    g = convert.gbuffer_from_numpy(_guides(7, 8, 8), "cpu")
    for mod, gb, P, T in ((filters, g, FilterParams, FilterType),
                          (jfilters, JGBuffer(**{
                              k: jnp.zeros(v.shape) for k, v in
                              convert.gbuffer_to_numpy(g).items()
                              if v is not None}), JFilterParams, JFilterType)):
        with pytest.raises(ValueError, match="level"):
            mod.apply_filter(gb, P(type=T(ftype), level=1))


def test_filter_wrappers_refuse_gradients():
    g = _guides(8, 8, 8)
    x = torch.from_numpy(g["render"]).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        box_filter_cuda(x)
    with pytest.raises(RuntimeError, match="no backward"):
        gaussian_filter_cuda(x)
    with pytest.raises(RuntimeError, match="no backward"):
        cross_bilateral_cuda(x, *(torch.from_numpy(g[k]) for k in (
            "albedo", "normal", "depth")))
