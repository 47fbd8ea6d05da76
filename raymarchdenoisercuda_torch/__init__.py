"""raymarchdenoisercuda_torch — the PyTorch/CUDA port of the differentiable
raymarcher + SVGF denoiser.

Counterpart of ``raymarchdenoisercuda_tpu`` (the JAX/Pallas reference, which
this package never imports).  Plain tensor code is PyTorch; every kernel the
reference wrote in Pallas for the TPU becomes a CUDA C++ kernel for Hopper
(``ops/cuda/*.cu``), built on first use.  A function picks its kernel by the
device of its inputs: CUDA tensors launch the kernel, CPU tensors run the
plain PyTorch version that the tests hold against the JAX package.
"""

from .config import (
    FilterType,
    FilterParams,
    SVGFParams,
    CameraParams,
    RaymarchParams,
    WAVELET_SPLINE_5,
)
from .gbuffer import GBuffer, History, luminance, zeros_gbuffer

__version__ = "0.1.0"

__all__ = [
    "FilterType",
    "FilterParams",
    "SVGFParams",
    "CameraParams",
    "RaymarchParams",
    "WAVELET_SPLINE_5",
    "GBuffer",
    "History",
    "luminance",
    "zeros_gbuffer",
    "__version__",
]
