"""Self device ms a step of the span `rdt.backward` (`loss.backward()`):
its interval less the union of the adjoint spans inside it
(`rdt.render.bwd`, `rdt.temporal.bwd`, `rdt.atrous.bwd`): the adjoints
autograd takes from PyTorch's own operations (the loss, the
(de)modulation, the material planes' products) and any idle time among
them.  Moves step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.backward", "self_device_ms")
