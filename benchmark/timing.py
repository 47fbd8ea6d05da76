"""The benchmark's own timing arithmetic: the closed loop that measures the
window, percentiles, and the union of device intervals.

Times of the window come from the host clock around work that ends in a
synchronise; the intervals between consecutive completions come from CUDA
events recorded on the stream at each unit's end (device timestamps).
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Sequence, Tuple


def process_start_time() -> float:
    """The epoch second at which this process started (``/proc``), or now
    where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time()


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between the closest
    ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Sequence[Tuple[float, float]],
                 lo: float, hi: float) -> float:
    """Total length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]: time in which at least one of them runs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def closed_loop(dispatch: Callable[[int], None], seconds: float,
                in_flight: int, cuda):
    """Dispatch units (frames or steps) until ``seconds`` have passed on
    the host clock, with at most ``in_flight`` units outstanding: before
    unit n the host waits for unit n − in_flight's completion event.
    Returns ``(wall seconds, units, [ms between consecutive completion
    events])``; the wall runs from the first dispatch to the end of the
    last unit.  ``cuda`` is ``torch.cuda``; on the CPU (tests) pass None
    and the intervals come from the host clock."""
    events, stamps = [], []
    t0 = time.perf_counter()
    n = 0
    while True:
        if n >= in_flight and cuda is not None:
            events[n - in_flight].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
        dispatch(n)
        if cuda is not None:
            ev = cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            stamps.append(time.perf_counter() * 1e3)
        n += 1
    if cuda is not None:
        cuda.synchronize()
    wall = time.perf_counter() - t0
    if cuda is not None:
        steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        steps = [b - a for a, b in zip(stamps, stamps[1:])]
    return wall, n, steps
