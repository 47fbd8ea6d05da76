"""Self device ms a frame of the span `rdt.denoise` (`svgf_denoise_frame`):
its interval less the union of its children's (`rdt.temporal`,
`rdt.atrous`): the (de)modulation, the history's bookkeeping and the
reprojection counter's reduction, with any idle time among them.  Part
of glue_ms.serve.  Moves frame_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.denoise", "self_device_ms")
