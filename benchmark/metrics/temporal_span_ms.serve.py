"""Device ms a frame of the span `rdt.temporal` (the temporal step inside
`svgf_denoise_frame`: K3): the stream's time between its entry and exit
events.  It exceeds temporal_ms.serve (K3 by name) by the glue it encloses
and any idle time inside it.  Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.temporal")
