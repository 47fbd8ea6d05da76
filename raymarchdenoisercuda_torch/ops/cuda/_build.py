"""Build the port's CUDA kernels on first use and load them with ctypes.

Every ``*.cu`` file beside this module is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, which
``ctypes`` loads.  The sources include no PyTorch headers, which keeps the
build short: 7.7-11.1 s for all of them on an NVIDIA H100 80GB HBM3 machine
(700 W limit, CUDA 12.8), where a source built through
``torch.utils.cpp_extension.load``, which includes those headers, takes
minutes.

The library goes to ``build/torch_ext/`` at the repository root, named by a
hash of the sources and flags, so a changed source builds anew and an
unchanged one is loaded as it is.  Nothing is compiled at import time.

Flags: ``-O3`` and ``--fmad=false``; never ``--use_fast_math``.  Without
contracted multiply-adds the kernels round like their plain PyTorch twins
operation by operation, and division stays exact, which the motion
reprojection needs (a reciprocal's 1-ulp noise at zero motion flips the
temporal step's border test).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types; every one returns cudaError_t
SIGNATURES = {
    "rdt_zgrad": (_P, _P, _I, _I, _P),
    "rdt_atrous_level": (_P,) * 9,
    "rdt_temporal": (_P,) * 15,
    "rdt_march": (_P,) * 9,
    "rdt_shadow_shade": (_P,) * 14,
}


def sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home})")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"rdt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``verbose`` adds ``-Xptxas=-v`` (registers, spills) and prints nvcc's
    output.  Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
           "-o", tmp, *map(str, sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argument and
    result types declared for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rdt_error_string.argtypes = [ctypes.c_int]
    lib.rdt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = kernels().rdt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_input(t, name: str, shape, dtype, device) -> int:
    """Validate a tensor handed to a kernel and return its data pointer: the
    kernels take contiguous tensors of one dtype on one CUDA device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()
