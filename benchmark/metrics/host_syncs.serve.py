"""Synchronising CUDA calls a frame inside `rdt.frame` (CUDA's sync debug
mode at "warn" inside the unit), each noted with its span and the
program's line.  A sync stalls the host until the card drains: the
frames in flight no longer overlap.  Moves frame_ms."""

from benchmark.spans import host_syncs


def read(trace):
    return host_syncs(trace, "rdt.frame")
