"""Device ms a frame of the spatial filter's kernels (kernel_names/
atrous*.txt: K1, the five à-trous levels).  Moves frame_ms."""


def read(trace):
    return trace.layer_ms("atrous")
