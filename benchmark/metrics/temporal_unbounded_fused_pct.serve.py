"""The share, in %, of the window's unbounded temporal steps that took
the fused route (K3's body with the clamped bilinear gather, one launch,
in place of the history's channel-minor stack, the clamped gather and
PyTorch's epilogue): the program's host counter `temporal_unbounded_fused`
over `temporal_unbounded`, both counted by `ops/temporal_cuda.py` while
spans record.  100 where every serving frame with `max_motion` null takes
it.  Nothing where the window counts no unbounded step (a bounded cell)
or the program has no `temporal_unbounded_fused` counter (one without
the fused route).  Moves frame_ms."""

from benchmark.spans import report


def read(trace):
    rep = report()
    if rep is None:
        return None
    c = rep["counters"]
    if not c.get("temporal_unbounded") or "temporal_unbounded_fused" not in c:
        return None
    return 100.0 * c["temporal_unbounded_fused"] / c["temporal_unbounded"]
