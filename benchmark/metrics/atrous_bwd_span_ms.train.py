"""Device ms a step of the span `rdt.atrous.bwd` (the backward of
`_StoredSweep`: K2 x 5): the stream's time between its entry and exit
events.  It exceeds the K2 part of atrous_ms.train by the glue it encloses
and any idle time inside it.  Moves step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.atrous.bwd")
