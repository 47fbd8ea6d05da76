"""Self-registering, regex-filtered, timed case runner.

Counterpart of ``raymarchdenoisercuda_tpu/testing.py``, the Python form of
the reference's harness (``include/test.h``, ``src/test.cu``): ``@case_``
registers like the ``TEST(name)`` macro, ``skip`` keeps a body importable
without registering it like ``SKIP(name)``, and :func:`run` full-matches
labels against a regex (default ``.*``), times each case and prints
``Passed with X ms`` / ``Fail with <msg>`` in the reference's format.  The
command-line front end is ``python -m raymarchdenoisercuda_torch.cli -t``.
"""

from __future__ import annotations

import re
import time
import traceback
from typing import Callable, Dict, Optional

registered_funcs: Dict[str, Callable[[], None]] = {}


def case_(name: Optional[str] = None):
    """Register a runnable case (the reference's ``TEST(name)``)."""

    def deco(fn):
        registered_funcs[name or fn.__name__] = fn
        return fn

    if callable(name):  # used bare: @case_
        fn, name = name, None
        return deco(fn)
    return deco


def skip(name: Optional[str] = None):
    """Keep the body importable without registering it (``SKIP``)."""

    def deco(fn):
        return fn

    if callable(name):
        return name
    return deco


def run(wildcard: str = ".*", out=print) -> bool:
    """Run the cases whose label full-matches ``wildcard``; True iff all
    passed."""
    out("Available tests:")
    for label in registered_funcs:
        out(f"\t{label}")
    pattern = re.compile(wildcard)
    ok = True
    for label, fn in registered_funcs.items():
        if not pattern.fullmatch(label):
            continue
        out(f"Running test {label}")
        t0 = time.perf_counter()
        try:
            fn()
            ms = (time.perf_counter() - t0) * 1e3
            out(f"\tPassed with {ms:.3f} ms")
        except Exception as e:  # noqa: BLE001 - the runner survives any case
            ok = False
            out(f"\tFail with {e}")
            traceback.print_exc()
    return ok
