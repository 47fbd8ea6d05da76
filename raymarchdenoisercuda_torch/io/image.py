"""PNG image I/O and uint8 <-> float plane conversion.

Counterpart of ``raymarchdenoisercuda_tpu/io/image.py`` (the reference's
stb-based ``Image`` class): load PNGs with a forced channel count, save
them, raise :class:`ImageIOError` on failure.  PIL reads and writes the
files; the optional C++ library in ``native/`` converts between layouts
when it is built (:mod:`.native`), with numpy otherwise.

Layout: images on disk are interleaved uint8 (H, W, C); planes are planar
float32 (C, H, W) in [0, 1].  Everything here is host-side numpy: the
dataset functions (``io/dataset.py``) move the planes to a device.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image as _PILImage


class ImageIOError(RuntimeError):
    """Load or save failure (the reference throws ``std::runtime_error``
    with ``stbi_failure_reason``)."""


def load_png(path: str, channels: int = 3) -> np.ndarray:
    """Load a PNG as interleaved uint8 (H, W, channels); ``channels`` (1, 3
    or 4) forces the channel count like stbi_load's desired_channels."""
    if not os.path.exists(path):
        raise ImageIOError(f"could not open image: {path}")
    try:
        with _PILImage.open(path) as im:
            mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
            arr = np.asarray(im.convert(mode), dtype=np.uint8)
    except Exception as e:  # decode errors, like stbi_failure_reason
        raise ImageIOError(f"failed to load {path}: {e}") from e
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def save_png(path: str, data: np.ndarray) -> None:
    """Save interleaved uint8 (H, W, C) as a PNG."""
    data = np.asarray(data)
    if data.dtype != np.uint8:
        raise ImageIOError(f"save_png expects uint8, got {data.dtype}")
    if data.ndim == 3 and data.shape[2] == 1:
        data = data[:, :, 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        _PILImage.fromarray(data).save(path, format="PNG")
    except Exception as e:
        raise ImageIOError(f"failed to save {path}: {e}") from e


def to_planar_float(img_u8: np.ndarray) -> np.ndarray:
    """Interleaved uint8 (H, W, C) -> planar float32 (C, H, W) in [0, 1]."""
    from . import native

    if native.available():
        return native.u8_to_planar_f32(np.ascontiguousarray(img_u8))
    return np.ascontiguousarray(
        img_u8.astype(np.float32).transpose(2, 0, 1)) / 255.0


def from_planar_float(planes: np.ndarray) -> np.ndarray:
    """Planar float32 (C, H, W) in [0, 1] -> interleaved uint8 (H, W, C),
    clipped and rounded half away from zero."""
    from . import native

    planes = np.asarray(planes, dtype=np.float32)
    if native.available():
        return native.planar_f32_to_u8(np.ascontiguousarray(planes))
    x = np.clip(planes, 0.0, 1.0) * 255.0
    return np.floor(x + 0.5).astype(np.uint8).transpose(1, 2, 0)


def load_plane(path: str, channels: int = 3) -> np.ndarray:
    """Load a PNG as a planar float32 (C, H, W) plane in [0, 1]."""
    return to_planar_float(load_png(path, channels))


def save_plane(path: str, planes: np.ndarray) -> None:
    """Save a planar float32 (C, H, W) plane in [0, 1] as a PNG."""
    save_png(path, from_planar_float(planes))
