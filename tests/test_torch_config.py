"""The port's mirrored config dataclasses equal the JAX package's, field by
field, defaults included; and the port imports no jax."""

import dataclasses
import pathlib
import re

import pytest

import raymarchdenoisercuda_tpu as rdt
import raymarchdenoisercuda_torch as rdt_torch
from raymarchdenoisercuda_tpu import config as jcfg
from raymarchdenoisercuda_torch import config as tcfg

CLASSES = ["FilterParams", "SVGFParams", "CameraParams", "RaymarchParams",
           "BenchConfig"]


def _fields(cls):
    # the two FilterType enums are distinct classes: compare members by value
    return [(f.name, f.type, getattr(f.default, "value", f.default),
             f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(a) == _fields(b)
    assert a.__dataclass_params__.frozen and b.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["FilterParams", "SVGFParams",
                                  "CameraParams", "RaymarchParams"])
def test_config_default_instances_match(name):
    a = dataclasses.asdict(getattr(jcfg, name)())
    b = dataclasses.asdict(getattr(tcfg, name)())
    # the enum classes differ; compare FilterType by value
    norm = {k: getattr(v, "value", v) for k, v in a.items()}
    assert norm == {k: getattr(v, "value", v) for k, v in b.items()}


def test_filter_type_and_spline_match():
    assert ([(m.name, m.value) for m in jcfg.FilterType]
            == [(m.name, m.value) for m in tcfg.FilterType])
    assert jcfg.WAVELET_SPLINE_5 == tcfg.WAVELET_SPLINE_5


@pytest.mark.parametrize("cls,kw", [
    ("FilterParams", {"depth": 0}), ("FilterParams", {"radius": -1}),
    ("FilterParams", {"level": -1}), ("SVGFParams", {"iterations": 0}),
    ("SVGFParams", {"pyramid_from": 0})])
def test_config_validation_matches(cls, kw):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kw)


def test_package_exports_match():
    assert set(rdt.__all__) == set(rdt_torch.__all__)


def test_port_imports_no_jax():
    root = pathlib.Path(rdt_torch.__file__).parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|raymarchdenoisercuda_tpu)\b",
                     re.M)
    offenders = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []


def test_gbuffer_model_and_conversion_roundtrip(rng):
    import jax.numpy as jnp
    import numpy as np
    import torch

    from raymarchdenoisercuda_tpu.gbuffer import (
        History, luminance, zeros_gbuffer)
    from raymarchdenoisercuda_torch import convert
    from raymarchdenoisercuda_torch.gbuffer import (
        History as THistory, luminance as tluminance,
        zeros_gbuffer as tzeros_gbuffer)

    H, W = 6, 10
    c = rng.random((3, H, W), dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(luminance(jnp.asarray(c))),
                                  tluminance(torch.from_numpy(c)).numpy())

    jh = History.zeros(H, W).replace(
        color=jnp.asarray(c), length=jnp.full((H, W), 3.0))
    th = convert.history_from_numpy(convert.fields_to_numpy(jh), "cpu")
    back = convert.history_to_numpy(th)
    for name, want in convert.fields_to_numpy(jh).items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    zh = convert.history_to_numpy(THistory.zeros(H, W, device="cpu"))
    for name, want in convert.fields_to_numpy(History.zeros(H, W)).items():
        np.testing.assert_array_equal(zh[name], want, err_msg=name)

    jg = zeros_gbuffer(H, W)
    tg = tzeros_gbuffer(H, W, device="cpu")
    assert tg.shape == (H, W) and tg.height == H and tg.width == W
    got = convert.gbuffer_to_numpy(
        convert.gbuffer_from_numpy(convert.fields_to_numpy(jg), "cpu"))
    for name, want in convert.fields_to_numpy(jg).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        np.testing.assert_array_equal(
            convert.gbuffer_to_numpy(tg)[name], want, err_msg=name)
