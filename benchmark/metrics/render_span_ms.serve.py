"""Device ms a frame of the span `rdt.render` (`render_gbuffer_window`:
rays, K7, the material lookup, K8): the stream's time between its entry
and exit events.  It exceeds render_ms.serve (the renderer's kernels by
name) by the glue it encloses (rays, lookup) and any idle time inside it.
Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.render")
