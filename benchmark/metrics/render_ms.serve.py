"""Device ms a frame of the renderer's kernels (K7 march, K8 shadow and
shading; kernel_names/renderer*.txt).  Moves frame_ms."""


def read(trace):
    return trace.layer_ms("renderer")
