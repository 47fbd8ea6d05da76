"""Host ms a frame inside the span `rdt.frame` (`FramePipeline.forward`):
the host's time to enqueue a frame, in the traced window (the profiler
adds its own cost to every operation, so this reads above the untraced
enqueue).  Against the frame's device time it is the host's margin under
the 2-in-flight loop.  Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.frame", "host_ms")
