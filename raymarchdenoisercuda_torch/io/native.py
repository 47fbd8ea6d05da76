"""ctypes binding of the optional C++ host library ``native/librdt_native.so``.

The port's own copy of ``raymarchdenoisercuda_tpu/io/native.py`` (that
package's ``__init__`` imports jax).  ``native/rdt_native.cpp`` exports:

* ``rdt_u8_to_planar_f32`` / ``rdt_planar_f32_to_u8``: the layout and type
  conversions on the host side of the image I/O;
* ``rdt_box_filter_u8``: an independent C++ implementation of the
  reference's box-filter semantics, the oracle of ``box_filter_u8``.

Build it with ``python3 native/build.py``.  Without it the conversions use
numpy (``io/image.py``) and the oracle tests skip.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "native", "librdt_native.so")


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    for name, argtypes in (
            ("rdt_u8_to_planar_f32", [u8p, f32p, i, i, i]),
            ("rdt_planar_f32_to_u8", [f32p, u8p, i, i, i]),
            ("rdt_box_filter_u8", [u8p, u8p, i, i, i, i, i])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def u8_to_planar_f32(img: np.ndarray) -> np.ndarray:
    h, w, c = img.shape
    out = np.empty((c, h, w), dtype=np.float32)
    _load().rdt_u8_to_planar_f32(img, out, h, w, c)
    return out


def planar_f32_to_u8(planes: np.ndarray) -> np.ndarray:
    c, h, w = planes.shape
    out = np.empty((h, w, c), dtype=np.uint8)
    _load().rdt_planar_f32_to_u8(planes, out, h, w, c)
    return out


def box_filter_u8(img: np.ndarray, radius: int, depth: int,
                  grayscale_quirk: bool) -> np.ndarray:
    """The C++ oracle of the reference average filter on interleaved uint8
    RGB (H, W, 3); ``grayscale_quirk`` as in ``ops.boxfilter.box_filter_u8``."""
    h, w, c = img.shape
    if c != 3:
        raise ValueError("the oracle takes RGB")
    out = np.empty_like(img)
    _load().rdt_box_filter_u8(img, out, h, w, radius, depth,
                              int(grayscale_quirk))
    return out
