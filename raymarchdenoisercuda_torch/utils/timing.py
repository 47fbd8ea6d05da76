"""Device timing and device information.

Times on the card come from CUDA events, never from a host clock without a
synchronise (PyTorch returns before the device finishes).  Nothing here
falls back to the CPU: without a card these functions raise.
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch


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


def nvidia_smi_name_power() -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card), e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
