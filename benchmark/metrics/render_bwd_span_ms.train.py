"""Device ms a step of the span `rdt.render.bwd` (the backward of
`_ShadowShade`, `_TableLookup` and, where geometry takes a gradient,
`_March`, `_Norm3`, `_Abs`): the stream's time between each record's
entry and exit events, summed.  PyTorch's kernels of these adjoints are
part of glue_ms.train; any idle time inside them counts too.  Moves
step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.render.bwd")
