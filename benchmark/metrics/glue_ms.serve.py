"""Device ms a frame of every device operation that is none of the port's
kernels: PyTorch's own kernels, copies and fills (the glue).  Moves frame_ms."""


def read(trace):
    return trace.layer_ms(None)
