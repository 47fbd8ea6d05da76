"""The spatial filter's share of its roofline, in %: the least time the
card could take for the frame's sweep (``roofline/atrous.py``: its bytes
over the HBM rate or its operations over the float32 rate, the larger)
over the device time of the filter's kernels a frame.  Moves frame_ms."""

from benchmark.roofline.atrous import sweep_work
from benchmark.roofline.peaks import least_seconds


def read(trace):
    ms = trace.layer_ms("atrous")
    if not ms:
        return None
    cfg = trace.config
    nbytes, ops = sweep_work(cfg["width"], cfg["height"],
                             cfg["svgf"]["radius"], cfg["svgf"]["iterations"])
    least_ms = least_seconds(nbytes, ops) * 1e3
    trace.notes.append(
        f"roofline atrous: {nbytes} bytes, {ops} operations a frame; least "
        f"{least_ms:.6f} ms against {ms:.6f} ms measured")
    return 100.0 * least_ms / ms
