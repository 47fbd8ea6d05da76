"""CUDA C++ sources of the kernels (``*.cu``) and the module that builds
them (``_build.py``)."""
