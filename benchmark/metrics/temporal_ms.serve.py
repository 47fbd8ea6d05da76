"""Device ms a frame of the temporal step's kernels (kernel_names/
temporal*.txt: K3, the fused inference step).  Moves frame_ms."""


def read(trace):
    return trace.layer_ms("temporal")
