"""The share, in %, of the traced window's pixels that took their history
from beyond the default reprojection bound (6 px): the program's device
counter `reprojected_far_px` (history length past 1, and |m0| or |m1|
past `SVGFParams().max_motion`; counted only with unbounded motion) over
`pixels`, over every frame of the window.  These are the histories a
bounded step would have dropped.  Nothing where the program has no such
counter.  Moves frame_ms (through the temporal step's work, not its
time)."""

from benchmark.spans import report


def read(trace):
    rep = report()
    if rep is None:
        return None
    c = rep["counters"]
    if not c.get("pixels") or "reprojected_far_px" not in c:
        return None
    return 100.0 * c["reprojected_far_px"] / c["pixels"]
