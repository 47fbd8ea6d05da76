"""Device ms a frame of the span `rdt.temporal.epilogue` (inside
`rdt.temporal`, on the unbounded route only: validity, the history
clamp's 3x3 min/max, the blends, the moments and the 7x7 spatial
variance, in PyTorch): the stream's time between its entry and exit
events, with the idle time of its host syncs.  Nothing where the program
has no such span.  Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.temporal.epilogue")
