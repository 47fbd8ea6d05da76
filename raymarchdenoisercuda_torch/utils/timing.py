"""Device timing, device information and metrics output.

Times on the card come from CUDA events, never from a host clock without a
synchronise (PyTorch returns before the device finishes).  Nothing here
falls back to the CPU: a function given the card and finding none raises.
:func:`time_fn` times CPU work on the host clock only when its caller says
the work runs on the CPU.

Counterpart of ``raymarchdenoisercuda_tpu/utils/timing.py`` (the
reference's per-test timing, :class:`Timer`, ``printGPUProperties`` and
CSV dumps, and :func:`trace`, the profiler trace of a block of work).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Callable

import torch


class Timer:
    """Wall-clock timer of a block of work (``with Timer() as t: ...``, then
    ``t.ms``), the JAX package's ``Timer``: on exit it waits for the card's
    outstanding work first (PyTorch returns before the device finishes), on
    the device of the result registered by :meth:`sync`, or on every card
    when none was; work on the CPU needs no wait.  A host clock: for a
    kernel's own time use :class:`CudaTimer` or :func:`device_ms`."""

    def __init__(self):
        self.ms = 0.0
        self._out = None

    def sync(self, out):
        """Register the work's result to wait on at exit; returns it."""
        self._out = out
        return out

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            out = self._out
            if isinstance(out, torch.Tensor):
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
            elif torch.cuda.is_available():
                torch.cuda.synchronize()
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


class CudaTimer:
    """Context manager timing the work enqueued on the current stream
    inside it: ``with CudaTimer() as t: ...``, then ``t.ms``."""

    def __enter__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        self._end.synchronize()
        self.ms = self._start.elapsed_time(self._end)
        return False


def cuda_time_ms(fn: Callable[[], object], *, repeats: int = 10,
                 warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after ``warmup``
    calls, from CUDA events around ``repeats`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with CudaTimer() as t:
        for _ in range(repeats):
            fn()
    return t.ms / repeats


def device_ms_by_kernel(fn: Callable[[], object],
                        calls: int) -> dict:
    """``{kernel name: device ms a call}`` of ``calls`` calls of ``fn``
    under ``torch.profiler`` (after one call outside it); memsets and fills
    count as kernels here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return {k: v / calls for k, v in out.items()}


def device_ms(fn: Callable[[], object], calls: int) -> float:
    """Device milliseconds a call of ``fn``, every kernel and memset summed
    (:func:`device_ms_by_kernel`): the card's work without the host's."""
    return sum(device_ms_by_kernel(fn, calls).values())


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """``torch.profiler`` over the work inside the block (the host's
    operators, and the card's kernels and copies where CUDA is available),
    written on exit as a Chrome trace, ``<log_dir>/<name>.json`` (open it
    in Perfetto or chrome://tracing).  Yields the profiler; the JAX
    package's ``trace`` is the same context over ``jax.profiler``.  Name a
    span with ``torch.profiler.record_function``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def time_fn(fn: Callable, *args, repeats: int = 10, warmup: int = 1,
            device="cuda", **kw):
    """``(seconds per call, last output)`` of ``fn(*args, **kw)`` after
    ``warmup`` calls: CUDA events around ``repeats`` back-to-back calls when
    ``device`` is a CUDA device, the host clock when it is the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        with CudaTimer() as t:
            for _ in range(repeats):
                out = fn(*args, **kw)
        return t.ms / 1e3 / repeats, out
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    return (time.perf_counter() - t0) / repeats, out


def mpix_per_s(height: int, width: int, seconds: float) -> float:
    return height * width / seconds / 1e6


def nvidia_smi_name_power() -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card), e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def print_device_properties(device="cuda") -> dict:
    """Print and return what the device is (the reference's
    ``printGPUProperties``): for the card, every CUDA device's name, memory
    and multiprocessor count from ``torch.cuda.get_device_properties``, and
    ``nvidia-smi``'s name and power limit; for the CPU, its thread count."""
    if torch.device(device).type != "cuda":
        entry = {"id": 0, "platform": "cpu",
                 "threads": torch.get_num_threads()}
        print(f"device 0: cpu ({entry['threads']} threads)")
        return {"devices": [entry]}
    info = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        entry = {"id": i, "platform": "gpu", "kind": p.name,
                 "memory_bytes": p.total_memory,
                 "multiprocessors": p.multi_processor_count,
                 "capability": f"{p.major}.{p.minor}"}
        info.append(entry)
        print(f"device {i}: {p.name} (sm_{p.major}{p.minor}), "
              f"{p.total_memory / 2**30:.1f} GiB, "
              f"{p.multi_processor_count} multiprocessors")
    smi = nvidia_smi_name_power()
    print(f"nvidia-smi: {smi}")
    return {"devices": info, "nvidia_smi": smi}


class CsvDump:
    """Pipe-separated benchmark dump (``label|ms|key=value...``)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def row(self, label: str, ms: float, **extra):
        with open(self.path, "a") as f:
            cells = [label, f"{ms:.4f}"] + [f"{k}={v}" for k, v in extra.items()]
            f.write("|".join(cells) + "\n")


def write_metrics_json(path: str, metrics: dict) -> None:
    """Write ``metrics`` as sorted, indented JSON."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
