"""Device ms a frame of the span `rdt.atrous` (the sweep inside
`svgf_denoise_frame`: K1 x 5 and the depth gradient): the stream's time
between its entry and exit events.  It exceeds atrous_ms.serve (the
filter's kernels by name) by the glue it encloses and any idle time
inside it.  Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.atrous")
