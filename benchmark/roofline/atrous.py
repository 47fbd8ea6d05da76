"""The work of the à-trous sweep (the SVGF spatial filter), counted from
the configuration so that it is the same whatever implements the sweep.

Bytes: the sweep's inputs read once (colour 3, variance 1, normal 3, depth
1 float32 planes) and its outputs written once (the denoised colour 3 and
variance 1, and the feedback level's colour 3 and variance 1): 16 planes,
64 bytes a pixel.

Operations, a tap of a pixel, from the reference's arithmetic
(``reference/denoise.py`` ``atrous_level``); each add, subtract, multiply,
divide, min/max clamp, exp and pow counts one, the sign operations
(abs, negation) none:

* the depth-gradient term ``|∇z·Δp|``: 2 multiplies, 1 add — 3;
* the luminance term ``|Δl| / σden``: subtract, divide — 2;
* the depth term ``|Δz| / (σz·|∇z·Δp| + ε)``: subtract, multiply, add,
  divide — 4;
* the normal term ``max(max(n·n_q, 0), 1e-20)^σn``: 3 multiplies, 2 adds,
  2 clamps, pow — 8;
* the weight ``h·mask·exp(wz + wl)·wn``: add, exp, 3 multiplies — 5;
* the accumulation: colour 3 multiplies and 3 adds, variance ``w·w·v``
  added (3), the normaliser's add (1) — 10.

That is 32 a tap, times (2r + 1)² taps, ``iterations`` levels and the
pixels.  The per-level work outside the taps (the variance blur, the
normalisation) is not counted, so the count is a floor and the roofline
share cannot pass 100 % by it.  A fused implementation that skips levels'
traffic lowers the bytes it moves, not this count.
"""

OPS_PER_TAP = 3 + 2 + 4 + 8 + 5 + 10
PLANES_READ = 3 + 1 + 3 + 1
PLANES_WRITTEN = 3 + 1 + 3 + 1
BYTES_PER_FLOAT = 4


def sweep_work(width: int, height: int, radius: int, iterations: int):
    """``(bytes, operations)`` of one sweep of a width x height frame."""
    pixels = width * height
    nbytes = (PLANES_READ + PLANES_WRITTEN) * BYTES_PER_FLOAT * pixels
    ops = OPS_PER_TAP * (2 * radius + 1) ** 2 * iterations * pixels
    return nbytes, ops
