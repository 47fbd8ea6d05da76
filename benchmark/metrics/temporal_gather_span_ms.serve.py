"""Device ms a frame of the span `rdt.temporal.gather` (inside
`rdt.temporal`, on the unbounded route only: the history stacked
channel-minor and the clamped gather, KGp and KG on the card): the
stream's time between its entry and exit events.  Nothing where the
program has no such span (the bounded routes, or a program before it).
Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.temporal.gather")
