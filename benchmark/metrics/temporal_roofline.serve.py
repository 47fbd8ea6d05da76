"""The temporal step's share of its roofline, in %: the least time the
card could take for a frame's step (``roofline/temporal.py``: 104 bytes a
pixel over the HBM rate, or its operations over the float32 rate, the
larger) over the device ms a frame of the span `rdt.temporal`, whatever
route ran inside it.  Nothing where the program has no such span.  Moves
frame_ms."""

from benchmark.roofline.peaks import least_seconds
from benchmark.roofline.temporal import step_work
from benchmark.spans import span_ms


def read(trace):
    ms = span_ms(trace, "rdt.temporal")
    if not ms:
        return None
    cfg = trace.config
    sv = cfg["svgf"]
    nbytes, ops = step_work(cfg["width"], cfg["height"], sv["history_clamp"],
                            sv["variance_boost_frames"])
    least_ms = least_seconds(nbytes, ops) * 1e3
    trace.notes.append(
        f"roofline temporal: {nbytes} bytes, {ops} operations a frame; "
        f"least {least_ms:.6f} ms against {ms:.6f} ms measured")
    return 100.0 * least_ms / ms
