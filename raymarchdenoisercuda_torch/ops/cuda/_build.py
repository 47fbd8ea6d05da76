"""Build the port's CUDA kernels on first use and load them with ctypes.

Every ``*.cu`` file beside this module is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together (the
à-trous level forward's instantiations are split one radius a source for
that reason; the ``*.cuh`` headers they share are hashed with them), and
the objects are linked into ONE shared library with a plain C interface,
which ``ctypes`` loads.  The sources include no PyTorch headers, which keeps
the build short (seconds; ``chip_smoke.py`` prints the time), where a source
built through ``torch.utils.cpp_extension.load``, which includes those
headers, takes minutes.

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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types; every one returns cudaError_t
SIGNATURES = {
    "rdt_zgrad": (_P, _P, _I, _I, _P),
    "rdt_atrous_level": (_P,) * 10 + (_I,) + (_P,) * 4,
    "rdt_atrous_bwd_stored": (_P,) * 6 + (_I,) * 5 + (_P,) * 2,
    "rdt_atrous_bwd": (_P,) * 14,
    "rdt_atrous_wgrad_bwd": (_P,) * 20,
    "rdt_temporal": (_P,) * 16,
    "rdt_gather": (_P,) * 3 + (_I,) * 3 + (_P,) * 2,
    "rdt_gather_bwd": (_P,) * 5 + (_I,) * 5 + (_P,) * 2,
    "rdt_clamped_gather": (_P,) * 3 + (_I,) * 4 + (_P,),
    "rdt_clamped_gather_bwd": (_P,) * 6 + (_I,) * 5 + (_P,),
    "rdt_stack_channel_minor": (_P,) * 6 + (_I, _P),
    "rdt_march": (_P,) * 9 + (_I, _P),
    "rdt_cone_seed": (_P,) * 7 + (_I, _P),
    "rdt_cone_seed_camera": (_P,) * 8 + (_I, _P),
    "rdt_shadow_shade": (_P,) * 13 + (_I, _P),
    "rdt_shadow": (_P,) * 6 + (_I, _P),
    "rdt_box_filter": (_P,) * 2 + (_I,) * 5 + (_P,),
    "rdt_gaussian_filter": (_P,) * 4,
    "rdt_filter_pass": (_P,) * 2 + (_I,) * 4 + (_P, _I, _P),
    "rdt_cross_bilateral": (_P,) * 8,
}


def sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def headers():
    """The ``*.cuh`` headers the sources include (hashed with them)."""
    return sorted(_SRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home})")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"rdt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, run in parallel, then one link.  ptxas
    reports each kernel's registers, stack and spills (``-Xptxas=-v``);
    the report is kept beside the library (:func:`resource_report` reads
    it), and ``verbose`` prints it with the rest of nvcc's output.  Returns
    the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # build in a private directory, then rename the library: a concurrent
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        failed, logs = [], []
        for cmd, proc in procs:
            log = proc.communicate()[0]
            logs.append(log)
            if verbose or proc.returncode != 0:
                print(log, flush=True)
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        if failed:
            raise RuntimeError("nvcc failed: " + "; ".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-gencode=arch=compute_90a,code=sm_90a",
               "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
            raise RuntimeError(f"nvcc link failed: {' '.join(cmd)}")
        report_path(out).write_text("\n".join(logs))
        os.replace(lib, out)
    return out


def report_path(lib: Path) -> Path:
    """Where :func:`build` keeps ptxas's report of the library ``lib``."""
    return lib.with_suffix(".ptxas.txt")


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_resources(text: str) -> dict:
    """``{mangled kernel name: (registers, stack bytes, spill-store bytes,
    spill-load bytes)}`` from ptxas's ``-v`` output."""
    found, name, frame = {}, None, (0, 0, 0)
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = _FRAME.search(line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = _REGS.search(line)
        if m and name:
            found[name] = (int(m.group(1)),) + frame
            name = None
    return found


def resource_report() -> dict:
    """:func:`parse_resources` of the built library's report (building it
    first if needed)."""
    return parse_resources(report_path(build()).read_text())


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


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    adjoint: its output would otherwise come back without a ``grad_fn``,
    and the gradient would be lost without an error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad (run it under "
            f"torch.no_grad(), or use the differentiable entry point)")


def check_canvas(t, name: str, shape, dtype, device) -> int:
    """Validate a canvas handed to a kernel (a tile plus its margins) and
    return its data pointer: as :func:`check_input`, but a view into a
    larger tensor is taken as it is, provided its columns are contiguous
    (the kernel reads it by its row and plane strides)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: columns not contiguous")
    return t.data_ptr()


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
