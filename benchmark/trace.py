"""The traced window: ``torch.profiler`` over the window, and what the
per-layer metrics read from its trace.

Device time goes to a layer by the profiler's kernel names
(``kernel_names/<layer>*.txt``); a device operation that matches no layer
is PyTorch's own work, the glue.  Busy time is the union of the device
operations' intervals, so work on two streams at once counts once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional

from .timing import gaps, union_length

WINDOW_SPAN = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BREAKDOWN_ENTRIES = 10
# how far back, in host events, a gap looks for one that covers it
HOST_SCAN = 2000


def profile(run: Callable[[], object]):
    """Run ``run()`` under the profiler (CPU and CUDA activities) inside
    the span ``benchmark.window``; returns ``(its result, the trace's
    events)``.  The trace goes through a file in a temporary directory
    (under ``TMPDIR``), removed before this returns."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            result = run()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return result, events


class Trace:
    """The window's device operations and host activity, in µs."""

    def __init__(self, events: List[dict], units: int, config: dict,
                 layers: Dict[str, List[str]]):
        self.units = units
        self.config = config
        self.notes: List[str] = []
        spans = [e for e in events if e.get("name") == WINDOW_SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError("the trace holds no window span")
        self.lo = float(spans[0]["ts"])
        self.hi = self.lo + float(spans[0]["dur"])
        self.device = []   # (name, start, end) inside the window
        host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                if t > self.lo and s < self.hi:
                    self.device.append((e["name"], max(s, self.lo),
                                        min(t, self.hi)))
            elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_SPAN:
                host.append((s, t, e["name"]))
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        self._compiled = {k: [re.compile(p) for p in v]
                          for k, v in layers.items()}
        self._layer: Dict[str, Optional[str]] = {}

    # -- the device ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(s, t) for _, s, t in self.device],
                            self.lo, self.hi) / 1e6

    def layer_of(self, name: str) -> Optional[str]:
        if name not in self._layer:
            self._layer[name] = next(
                (layer for layer, pats in self._compiled.items()
                 if any(p.search(name) for p in pats)), None)
        return self._layer[name]

    def layer_ms(self, layer: Optional[str]) -> Optional[float]:
        """Device ms a unit of the operations of ``layer`` (None: the glue,
        the operations of no layer), or None where none ran."""
        total, found = 0.0, False
        for name, s, t in self.device:
            if self.layer_of(name) == layer:
                total += t - s
                found = True
        if not found or self.units <= 0:
            return None
        return total / 1e3 / self.units

    # -- the breakdown ------------------------------------------------------

    def host_activity(self, t: float) -> str:
        """The innermost host event running at ``t``: the latest to start
        among those that cover it."""
        i = bisect.bisect_right(self._host_starts, t)
        for j in range(i - 1, max(i - HOST_SCAN, 0) - 1, -1):
            if self._host[j][1] > t:
                return self._host[j][2]
        return "(python between operations)"

    def breakdown(self) -> dict:
        """The device operations with the most time, and the idle time by
        what the host was doing when each gap began, in seconds."""
        ops = collections.Counter()
        for name, s, t in self.device:
            ops[name] += (t - s) / 1e6
        idle = collections.Counter()
        for s, t in gaps([(s, t) for _, s, t in self.device], self.lo,
                         self.hi):
            idle[self.host_activity(s)] += (t - s) / 1e6
        return {"device_ops": [[n, v] for n, v in
                               ops.most_common(BREAKDOWN_ENTRIES)],
                "idle_gaps": [[n, v] for n, v in
                              idle.most_common(BREAKDOWN_ENTRIES)]}
