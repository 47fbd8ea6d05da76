"""Device ms a step of every device operation that is none of the port's
kernels: PyTorch's own kernels, copies and fills (the glue, autograd
and Adam among them).  Moves step_ms."""


def read(trace):
    return trace.layer_ms(None)
