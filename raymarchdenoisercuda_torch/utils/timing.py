"""Device timing, device information, and the program's spans and counters.

Times on the card come from CUDA events, never from a host clock without a
synchronise (PyTorch returns before the device finishes).  Nothing here
falls back to the CPU: a function given the card and finding none raises.
:func:`time_fn` times CPU work on the host clock only when its caller says
the work runs on the CPU.

The spans (:func:`span`, :func:`spanned`) and counters (:func:`count`,
:func:`count_device`) at the program's layer boundaries record only while
a ``torch.profiler`` session records; :func:`report` sums them.

Counterpart of ``raymarchdenoisercuda_tpu/utils/timing.py`` (the
reference's per-test timing, :class:`Timer`, ``printGPUProperties``, and
:func:`trace`, the profiler trace of a block of work).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import subprocess
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

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
    package's ``trace`` is the same context over ``jax.profiler``.  The
    program's spans (:func:`span`) record inside it, and appear in the
    trace as ``user_annotation`` events."""
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


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

_PROFILER = torch.autograd.profiler        # its _is_profiler_enabled flag
_OFF = contextlib.nullcontext()
SYNC_WARNING = "called a synchronizing CUDA operation"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)


class _Record:
    """One span: its name, its parent record (None at a root), its unit id
    (None outside a unit), the host clock at entry and exit (seconds) and
    its CUDA events at entry and exit (None on the host clock)."""

    __slots__ = ("name", "parent", "unit", "t0", "t1", "e0", "e1")

    def __init__(self, name, parent, unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0 = self.t1 = self.e0 = self.e1 = None

    def interval(self, origin: "_Record"):
        """``(start, end)`` in ms after ``origin``'s entry, on the device's
        clock (the stream's events) or the host's."""
        if self.e0 is None:
            return ((self.t0 - origin.t0) * 1e3, (self.t1 - origin.t0) * 1e3)
        return (origin.e0.elapsed_time(self.e0),
                origin.e0.elapsed_time(self.e1))


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def covered(intervals, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the union of ``(start, end)``
    intervals covers: where they overlap, the overlap counts once."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def _call_site() -> str:
    """``<package>/<module>.py:<line>`` of the innermost frame in the
    program's package outside this module."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE) and path != _THIS:
            return (f"{os.path.relpath(path, os.path.dirname(_PACKAGE))}:"
                    f"{f.f_lineno}")
        f = f.f_back
    return "(outside the program)"


class _SyncWatch:
    """While a unit runs with CUDA: its sync debug mode at "warn", and each
    synchronising call it reports counted under the innermost open span
    and the program's line that made it.  :meth:`close` restores the mode
    and the warning filters."""

    def __init__(self, recorder: "SpanRecorder"):
        self.recorder = recorder
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.shown = warnings.showwarning
        warnings.showwarning = self.show
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        if SYNC_WARNING not in str(message):
            return self.shown(message, category, filename, lineno, file,
                              line)
        r = self.recorder
        rec = r.innermost()
        with r.lock:
            r.syncs[(rec.name if rec else None, _call_site())] += 1

    def close(self):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.filters.__exit__(None, None, None)


class _Span:
    """An open span of :func:`span`."""

    __slots__ = ("recorder", "name", "unit", "rec", "stack", "annotation",
                 "watch", "began")

    def __init__(self, recorder: "SpanRecorder", name: str, unit: bool):
        self.recorder, self.name, self.unit = recorder, name, unit
        self.watch, self.began = None, False

    def __enter__(self):
        r = self.recorder
        self.stack = stack = r.stack()
        if self.unit and r.unit_stack is None:
            self.began = True
            r.units += 1
            r.unit, r.unit_stack = r.units, stack
            if r.cuda:
                self.watch = _SyncWatch(r)
        self.annotation = _PROFILER.record_function(self.name)
        self.annotation.__enter__()
        self.rec = rec = _Record(self.name, r.innermost(), r.unit)
        with r.lock:
            r.records.append(rec)
        stack.append(rec)
        rec.t0 = time.perf_counter()
        if r.cuda:
            rec.e0 = _event()
        return self

    def __exit__(self, *exc):
        rec, r = self.rec, self.recorder
        if rec.e0 is not None:
            rec.e1 = _event()
        rec.t1 = time.perf_counter()
        self.stack.pop()
        self.annotation.__exit__(*exc)
        if self.began:
            if self.watch is not None:
                self.watch.close()
            r.unit, r.unit_stack = None, None
        return False


class _BackwardSpan:
    """A span over part of a backward pass (see :func:`span_backward`)."""

    def __init__(self, recorder: "SpanRecorder", name: str, outputs, inputs):
        self.recorder, self.name = recorder, name
        self.open, self.left = None, len(inputs)
        for t in outputs:
            t.register_hook(self.begin)
        for t in inputs:
            t.register_hook(self.end)

    def begin(self, _grad):
        if self.open is None and self.recorder.active():
            self.open = _Span(self.recorder, self.name, False).__enter__()

    def end(self, _grad):
        self.left -= 1
        if self.left == 0 and self.open is not None:
            self.open.__exit__(None, None, None)


class SpanRecorder:
    """The spans and counters of one profiler session, kept in memory.

    A session starts at the first span or counter that finds a
    ``torch.profiler`` session recording after one that found none, or
    after :meth:`report`; it clears the previous session.  The device's
    clock is the CUDA stream's where CUDA is initialised as the session
    starts, else the host's (the program on CPU tensors)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.fresh = True
        self._clear()

    def _clear(self):
        self.records: List[_Record] = []
        self.counters: Dict[str, float] = {}
        self.device_counters: Dict[str, torch.Tensor] = {}
        self.syncs = collections.Counter()   # (span, call site) -> count
        self.units = 0
        self.cuda = False
        self.unit = None           # the open unit's id
        self.unit_stack = None     # the open spans of the thread that began it
        self._stacks: Dict[int, list] = {}   # thread id -> its open spans
        self._report = None

    def active(self) -> bool:
        """Whether a profiler session records (starting a session of
        spans where this is the first to find one after none)."""
        if not _PROFILER._is_profiler_enabled:
            self.fresh = True
            return False
        if self.fresh:
            with self.lock:
                if self.fresh:
                    self._clear()
                    self.cuda = torch.cuda.is_initialized()
                    self.fresh = False
        return True

    def stack(self) -> list:
        """This thread's open spans, outermost first."""
        return self._stacks.setdefault(threading.get_ident(), [])

    def innermost(self) -> Optional[_Record]:
        """The innermost open span of this thread; on a thread with none
        open (autograd's device thread), that of the thread that began the
        unit."""
        stack = self.stack() or self.unit_stack
        return stack[-1] if stack else None

    def count(self, name: str, n) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def count_device(self, name: str, value: torch.Tensor) -> None:
        value = value.detach()
        with self.lock:
            acc = self.device_counters.get(name)
            if acc is None:
                self.device_counters[name] = value.clone()
            else:
                acc.add_(value)

    def report(self) -> dict:
        """The session's sums (see :func:`report`); the next span that
        finds a profiler recording starts a new session."""
        if self._report is not None:
            return self._report
        self.fresh = True
        if self.cuda:
            torch.cuda.synchronize()
        done = [rec for rec in self.records if rec.t1 is not None]
        children = collections.defaultdict(list)
        for rec in done:
            if rec.parent is not None:
                children[id(rec.parent)].append(rec)
        spans: Dict[str, dict] = {}
        for rec in done:
            ms = rec.interval(rec)[1]
            inner = [c.interval(rec) for c in children[id(rec)]]
            s = spans.setdefault(rec.name, dict(
                count=0, host_ms=0.0, device_ms=0.0, self_device_ms=0.0))
            s["count"] += 1
            s["self_device_ms"] += ms - covered(inner, 0.0, ms)
            if not _inside_its_name(rec):
                s["host_ms"] += (rec.t1 - rec.t0) * 1e3
                s["device_ms"] += ms
        counters = dict(self.counters)
        for name, acc in self.device_counters.items():
            counters[name] = acc.item()
        counters["host_syncs"] = sum(self.syncs.values())
        syncs: Dict[Optional[str], Dict[str, int]] = {}
        for (name, site), n in sorted(self.syncs.items(), key=str):
            syncs.setdefault(name, {})[site] = n
        self._report = dict(clock="cuda" if self.cuda else "host",
                            units=self.units, spans=spans, counters=counters,
                            syncs=syncs)
        return self._report


def _inside_its_name(rec: _Record) -> bool:
    """Whether a span of ``rec``'s name encloses it (its time is then
    already in the outer one's)."""
    p = rec.parent
    while p is not None:
        if p.name == rec.name:
            return True
        p = p.parent
    return False


RECORDER = SpanRecorder()


def tracing() -> bool:
    """Whether spans and counters record now: a ``torch.profiler`` session
    is recording.  Guard work done only to feed a counter with it."""
    return RECORDER.active()


def span(name: str, unit: bool = False):
    """A span of the program named ``name``, as a context manager.

    Off (no ``torch.profiler`` session recording) it is one shared
    ``nullcontext``: no allocation, no CUDA event, no ``record_function``.
    On, it enters ``torch.profiler.record_function(name)`` (the span is a
    ``user_annotation`` in the profiler's trace, on the clock of the
    device's operations), records a timing CUDA event on the current stream
    at entry and at exit where CUDA is in use, and reads the host clock at
    both.  Its parent is the innermost open span of its thread, or on a
    thread with none open (autograd's device thread) that of the thread
    that began the unit.  ``unit=True`` makes it a unit (a frame or a
    training step) where none is open: every span inside shares its id,
    and on the card CUDA's sync debug mode is at "warn" inside it, each
    synchronising call counted (``host_syncs``) under the innermost open
    span."""
    if not RECORDER.active():
        return _OFF
    return _Span(RECORDER, name, unit)


def spanned(name: str, unit: bool = False):
    """A decorator: the function runs inside :func:`span` ``(name,
    unit)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name, unit):
                return fn(*args, **kw)
        return inner
    return wrap


def span_backward(name: str, outputs, inputs) -> None:
    """While spans record: a span ``name`` over the backward of the work
    that made ``outputs`` from ``inputs`` (tensors; those that require
    grad count), for work whose adjoint is autograd's and no Function of
    the program's.  A gradient hook opens it when the first of
    ``outputs`` has its gradient, and one closes it when the last of
    ``inputs`` has its own; autograd runs the nodes of one forward stretch
    together (later-made nodes first), so between the two it runs that
    stretch's adjoint.  Give only inputs that the work's gradient reaches:
    the span stays open until each has its gradient."""
    if not RECORDER.active():
        return
    outs = [t for t in outputs if t.requires_grad]
    ins = [t for t in inputs if t.requires_grad]
    if outs and ins:
        _BackwardSpan(RECORDER, name, outs, ins)


def count(name: str, n) -> None:
    """Add ``n`` to the host counter ``name`` while spans record."""
    if RECORDER.active():
        RECORDER.count(name, n)


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the tensor ``value`` into the device accumulator ``name`` while
    spans record (no synchronise: :func:`report` reads it)."""
    if RECORDER.active():
        RECORDER.count_device(name, value)


def report() -> dict:
    """The spans and counters of the last session that recorded any, once
    its work has completed (it synchronises the card first):

    * ``spans``: for each name, ``count`` (records), ``host_ms`` (host
      clock, entry to exit), ``device_ms`` (the stream's time between the
      span's two events: its work and any idle time inside it),
      ``self_device_ms`` (each record's interval less the union of its
      children's), all summed; a record inside one of its own name adds
      to the count and the self time only;
    * ``counters``: the host counters, the device accumulators and
      ``host_syncs``, the synchronising calls counted in units;
    * ``syncs``: ``{span: {call site: count}}`` of those calls;
    * ``units``, and ``clock``: "cuda" (the stream's events) or "host"
      (the program on CPU tensors: device times are host times)."""
    return RECORDER.report()


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
