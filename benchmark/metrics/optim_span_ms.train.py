"""Device ms a step of the span `rdt.optim` (Adam's step and the clip to
[0, 1]): the stream's time between its entry and exit events, any idle
time inside it included; its kernels are part of glue_ms.train.  Moves
step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.optim")
