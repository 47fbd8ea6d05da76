"""Device ms a step of the temporal step's kernels (kernel_names/
temporal*.txt: K4 and its adjoints K5/K6).  Moves step_ms."""


def read(trace):
    return trace.layer_ms("temporal")
