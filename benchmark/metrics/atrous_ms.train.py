"""Device ms a step of the spatial filter's kernels (kernel_names/
atrous*.txt: K1 in store mode and the adjoint K2).  Moves step_ms."""


def read(trace):
    return trace.layer_ms("atrous")
