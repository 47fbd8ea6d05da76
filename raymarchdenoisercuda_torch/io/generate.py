"""Camera paths for animated sequences.

Counterpart of ``orbit_camera`` in ``raymarchdenoisercuda_tpu/io/generate.py``
(numpy math, rounded to float32 as the reference rounds it, so both
packages see the same poses).
"""

from __future__ import annotations

import numpy as np

from ..ops.raymarch import Camera, make_camera


def orbit_camera(t: float, radius: float = 1.7, *, device="cpu") -> Camera:
    """Camera slowly orbiting and bobbing in front of the Cornell box.

    ``t`` in [0, 1) over the sequence; the motion is small enough that most
    pixels reproject."""
    ang = 0.25 * np.sin(2 * np.pi * t)
    x = radius * np.sin(ang) * 0.4
    y = 0.08 * np.sin(4 * np.pi * t)
    z = -radius + 0.12 * np.cos(2 * np.pi * t) - 0.12
    return make_camera([x, y, z], device=device)
