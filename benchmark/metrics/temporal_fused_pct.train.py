"""The share, in %, of the window's temporal steps that took the fused
route (K3 forward, its adjoint K16 backward, one autograd Function): the
program's host counter `temporal_fused` over `temporal_steps`, both
counted by `ops/temporal_cuda.py` while spans record.  100 where only the
render takes a gradient (the material fit's step); nothing where the
program has neither counter.  Moves step_ms (the fused route replaces K4
and PyTorch's epilogue and its autograd adjoint)."""

from benchmark.spans import report


def read(trace):
    rep = report()
    if rep is None:
        return None
    c = rep["counters"]
    if not c.get("temporal_steps"):
        return None
    return 100.0 * c.get("temporal_fused", 0) / c["temporal_steps"]
