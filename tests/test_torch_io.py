"""The port's image and dataset I/O and ``generate_sequence`` against the
JAX package's.

Tolerances: PNG round trips and the planar conversions are exact (the two
packages run the same numpy or ``native/`` code); frames written by one
package and read by the other load to the same arrays bit for bit.
``generate_sequence`` at 24x32: the albedo, depth and motion planes at atol
1e-4 and the normal plane at atol 5e-4, rtol 5e-3, the bounds of
``tests/test_torch_raymarch.py``, except exact geometric ties, found and
left out as in ``tests/test_torch_pipeline.py`` (albedo or depth apart by
more than 1e-4).  With the camera on the box's axis (frame 1 of 2, t = 0.5)
four rays of the 24x32 frame end exactly where two walls meet: the hit
point is the same (depth within 1e-5), and which wall's material wins is
decided by the last bit, which XLA and PyTorch round differently.  Four
pixels are 0.52 % of this small frame (the 48x64 frames of the pipeline
test allow 0.2 %), so a tie must keep its depth and ties may be at most
1 % of the frame.
The render plane is not compared: ``jax.random`` and ``torch.Generator``
draw different light samples (``tests/test_torch_raymarch.py`` holds the
spp > 1 render to JAX's on the same samples).
"""

import os

import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu import io as jio
from raymarchdenoisercuda_tpu.config import CameraParams as JCameraParams
from raymarchdenoisercuda_tpu.io import generate as jgenerate
from raymarchdenoisercuda_torch import convert, io
from raymarchdenoisercuda_torch.config import CameraParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer
from raymarchdenoisercuda_torch.io import generate, native

H, W = 24, 32


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (21, 34, channels), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    io.save_png(p, img)
    back = io.load_png(p, channels=channels)
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(jio.load_png(p, channels=channels), img)


def test_png_errors(tmp_path):
    with pytest.raises(io.ImageIOError):
        io.load_png(str(tmp_path / "nope.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(io.ImageIOError):
        io.load_png(str(bad))
    with pytest.raises(io.ImageIOError):
        io.save_png(str(tmp_path / "f.png"), np.zeros((2, 2, 3), np.float32))


def test_planar_conversions_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    planes = io.to_planar_float(img)
    assert planes.dtype == np.float32 and planes.shape == (3, 13, 17)
    np.testing.assert_array_equal(planes, jio.to_planar_float(img))
    np.testing.assert_array_equal(io.from_planar_float(planes), img)
    f = (rng.random((3, 11, 9)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(io.from_planar_float(f),
                                  jio.from_planar_float(f))
    p = io.to_planar_float(img[:, :, :1])
    np.testing.assert_array_equal(p, jio.to_planar_float(img[:, :, :1]))


def test_native_conversions_match_numpy():
    if not native.available():
        pytest.skip("native/librdt_native.so not built")
    img = np.random.default_rng(1).integers(0, 256, (9, 11, 3),
                                            dtype=np.uint8)
    np.testing.assert_allclose(
        native.u8_to_planar_f32(img),
        np.ascontiguousarray(img.astype(np.float32).transpose(2, 0, 1))
        / 255.0, atol=1e-7)
    np.testing.assert_array_equal(
        native.planar_f32_to_u8(native.u8_to_planar_f32(img)), img)


def _gbuf_numpy(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, h, w)).astype(np.float32)
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    return dict(render=(rng.random((3, h, w)) * 1.5).astype(np.float32),
                albedo=rng.random((3, h, w), dtype=np.float32), normal=n,
                depth=rng.random((h, w), dtype=np.float32),
                denoised=rng.random((3, h, w), dtype=np.float32))


def _assert_same_frame(a, b):
    for name in ("render", "albedo", "normal", "depth"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_frames_written_by_one_package_read_by_the_other(tmp_path):
    planes = _gbuf_numpy(2)
    # the port writes, both read
    io.save_frame(str(tmp_path), "port", 3,
                  convert.gbuffer_from_numpy(planes, "cpu"))
    got = convert.gbuffer_to_numpy(io.load_frame(str(tmp_path), "port", 3,
                                                 device="cpu"))
    _assert_same_frame(got, convert.fields_to_numpy(
        jio.load_frame(str(tmp_path), "port", 3)))
    assert os.path.exists(tmp_path / "port" / "3" / "denoised.png")
    # JAX writes, both read
    import jax.numpy as jnp
    from raymarchdenoisercuda_tpu.gbuffer import GBuffer as JGBuffer
    jio.save_frame(str(tmp_path), "jax", 5,
                   JGBuffer(**{k: jnp.asarray(v) for k, v in planes.items()}))
    got = convert.gbuffer_to_numpy(io.load_frame(str(tmp_path), "jax", 5,
                                                 device="cpu"))
    _assert_same_frame(got, convert.fields_to_numpy(
        jio.load_frame(str(tmp_path), "jax", 5)))
    # 8-bit planes: within one quantisation step of what was written
    np.testing.assert_allclose(got["albedo"], planes["albedo"],
                               atol=0.5 / 255 + 1e-6)
    np.testing.assert_allclose(got["render"], np.clip(planes["render"], 0, 1),
                               atol=0.5 / 255 + 1e-6)


def test_list_frames_and_iter_sequence(tmp_path):
    for f in (2, 10, 1):
        io.save_frame(str(tmp_path), "seq", f, convert.gbuffer_from_numpy(
            _gbuf_numpy(f, 4, 6), "cpu"))
    (tmp_path / "seq" / "notes").mkdir()
    (tmp_path / "seq" / "7").write_text("a file, not a frame")
    assert io.list_frames(str(tmp_path), "seq") == [1, 2, 10]
    assert io.list_frames(str(tmp_path), "seq") == jio.list_frames(
        str(tmp_path), "seq")
    frames = list(io.iter_sequence(str(tmp_path), "seq", device="cpu"))
    assert [g.shape for g in frames] == [(4, 6)] * 3
    want = io.load_frame(str(tmp_path), "seq", 10, device="cpu")
    assert torch.equal(frames[2].albedo, want.albedo)
    with pytest.raises(io.ImageIOError):
        io.list_frames(str(tmp_path), "missing")


def test_generate_sequence_matches_jax(tmp_path):
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jgenerate.generate_sequence(
        jroot, frames=2, cam_cfg=JCameraParams(width=W, height=H), spp=2)
    got = generate.generate_sequence(
        root, frames=2, cam_cfg=CameraParams(width=W, height=H), spp=2,
        device="cpu")
    assert io.list_frames(root, "cornell_anim") == [1, 2]
    for f, (g, j) in enumerate(zip(got, want)):
        a = convert.gbuffer_to_numpy(g)
        b = convert.fields_to_numpy(j)
        ties = ((np.abs(a["albedo"] - b["albedo"]).max(0) > 1e-4)
                | (np.abs(a["depth"] - b["depth"]) > 1e-4))
        # a tie keeps its hit point (depth) and differs in material only
        assert np.abs(a["depth"] - b["depth"])[ties].max(initial=0) <= 1e-5
        assert ties.mean() <= 1e-2, (f, int(ties.sum()))
        keep = ~ties
        for name in ("albedo", "depth", "motion"):
            np.testing.assert_allclose(a[name][..., keep], b[name][..., keep],
                                       rtol=0, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a["normal"][..., keep],
                                   b["normal"][..., keep], rtol=5e-3,
                                   atol=5e-4)
        assert np.isfinite(a["render"]).all()
        # the float planes read back exactly, by either package's reader
        back = generate.load_float_frame(root, "cornell_anim", f + 1,
                                         device="cpu")
        jback = generate.load_float_frame(jroot, "cornell_anim", f + 1,
                                          device="cpu")
        for name in ("render", "albedo", "normal", "depth", "motion"):
            assert torch.equal(getattr(back, name), getattr(g, name)), name
            np.testing.assert_array_equal(getattr(jback, name).numpy(),
                                          b[name], err_msg=name)
        # and the PNGs agree with the float planes to one quantisation step
        png = io.load_frame(root, "cornell_anim", f + 1, device="cpu")
        for name in ("render", "albedo", "depth"):
            np.testing.assert_allclose(
                getattr(png, name).numpy(), np.clip(a[name], 0, 1),
                rtol=0, atol=0.5 / 255 + 1e-6, err_msg=name)


def test_generate_main_writes_a_static_sequence(tmp_path, capsys):
    assert generate.main([str(tmp_path), "--frames", "2", "--size", "16",
                          "--spp", "2", "--static", "--scene", "s"],
                         device="cpu") == 0
    assert "wrote 2 frames" in capsys.readouterr().out
    a = generate.load_float_frame(str(tmp_path), "s", 1, device="cpu")
    b = generate.load_float_frame(str(tmp_path), "s", 2, device="cpu")
    assert isinstance(a, GBuffer) and a.shape == (16, 16)
    assert torch.equal(a.albedo, b.albedo)          # the camera stood still
    assert float(b.motion.abs().max()) < 1e-3        # ... so nothing moved
