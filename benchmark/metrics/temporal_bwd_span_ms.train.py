"""Device ms a step of the span `rdt.temporal.bwd`: the temporal step's
adjoint, from its outputs' gradient to its render input's (autograd of
the epilogue; the gather's adjoint K5/K6 has its own record where the
history takes a gradient, not in these cells).  Stream time between the
events, idle time inside included; its kernels are PyTorch's, part of
glue_ms.train.  Moves step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.temporal.bwd")
