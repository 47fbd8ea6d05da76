"""Plain PyTorch ops (CPU path and kernel oracles) and their CUDA kernel
wrappers (``*_cuda.py``)."""
