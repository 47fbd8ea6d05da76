"""The work of the SVGF temporal step, counted from the configuration so
that it is the same whatever implements the step (K3, or the clamped
gather and PyTorch's epilogue).

Bytes: the step's inputs read once and its outputs written once, float32
planes:

* reads: the history 10 (colour 3, moments 2, length, previous depth,
  previous normal 3), the render 3, the motion 2, the depth 1 and the
  normal 3;
* writes: the integrated colour 3, the variance 1, the moments 2 and the
  length 1;

26 planes, 104 bytes a pixel.

Operations a pixel, from the arithmetic of the unbounded reference
(``reference/denoise_unbounded.py`` ``temporal``), counted as
``atrous.py`` counts them (each add, subtract, multiply, divide, min/max
clamp and comparison one; floors, sign operations, selections and the
integer index arithmetic none):

* the reprojection: the position (2 adds), the fractions and their
  complements (4 subtracts), and for each of the 10 planes two rows' blends
  and one column blend of 2 multiplies and 1 add — 6 + 90;
* the validity: the position inside the image (4 comparisons), the depth
  test (subtract, clamp, multiply, comparison), the normals' dot product
  and its test (3 multiplies, 2 adds, a comparison), the length's test —
  15;
* the history clamp (``history_clamp``): the separable 3x3 min and max of
  3 channels (8 a channel) and the clamp's min and max (2 a channel) — 30;
* the blend weights: n + 1, two reciprocals, two maxima — 5;
* the colour's blend: 1 − alpha, then 2 multiplies and 1 add a channel —
  10;
* the luminance (3 multiplies, 2 adds) and its square — 6;
* the moments' blend: 1 − alpha_m, then 2 multiplies and 1 add a moment —
  7;
* the variance: m2 − m1², clamped at 0 — 3;
* the spatial variance while the history is short
  (``variance_boost_frames`` > 0): the 7x7 window sums of l and l² (6
  adds along rows and 6 along columns each), their normalisation (2
  multiplies), sm2 − sm1², clamped — 29.

The work that ``history_clamp`` or ``variance_boost_frames`` switch off is
not counted without them.  The per-row and per-column counts of the 7x7
normalisation are not counted, so the count is a floor; a pixel's bytes
bound the step at the card's peaks by far (about 2,000 operations a pixel
would match them).
"""

PLANES_READ = 10 + 3 + 2 + 1 + 3
PLANES_WRITTEN = 3 + 1 + 2 + 1
BYTES_PER_FLOAT = 4
OPS_REPROJECT = 6 + 10 * 9
OPS_VALIDITY = 4 + 4 + 6 + 1
OPS_CLAMP = 3 * (8 + 2)
OPS_BLEND = 5 + 10 + 6 + 7 + 3
OPS_SPATIAL_VARIANCE = 2 * (6 + 6) + 2 + 3


def step_work(width: int, height: int, history_clamp: bool = True,
              variance_boost_frames: int = 4):
    """``(bytes, operations)`` of one temporal step of a width x height
    frame."""
    pixels = width * height
    nbytes = (PLANES_READ + PLANES_WRITTEN) * BYTES_PER_FLOAT * pixels
    ops = OPS_REPROJECT + OPS_VALIDITY + OPS_BLEND
    if history_clamp:
        ops += OPS_CLAMP
    if variance_boost_frames > 0:
        ops += OPS_SPATIAL_VARIANCE
    return nbytes, ops * pixels
