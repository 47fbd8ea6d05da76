"""Synchronising CUDA calls a step inside `rdt.step` (CUDA's sync debug
mode at "warn" inside the unit), each noted with its span and the
program's line (autograd replays its device thread's warnings when
`loss.backward()` returns, so a sync in an adjoint is noted under
`rdt.backward`).  A sync stalls the host until the card drains.  Moves
step_ms."""

from benchmark.spans import host_syncs


def read(trace):
    return host_syncs(trace, "rdt.step")
