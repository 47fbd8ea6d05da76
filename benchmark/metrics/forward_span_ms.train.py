"""Device ms a step of the span `rdt.forward` (render, denoise, loss): the
stream's time between its entry and exit events, the glue it encloses
and any idle time inside it included.  Moves step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.forward")
