"""What the per-layer metrics of the program's own spans read.

The program (``raymarchdenoisercuda_torch.utils.timing``) records its
spans and counters while a ``torch.profiler`` session records, so a
``--trace 1`` window fills them; its ``report()``, called once the window
has synchronised, sums them.  A span's device ms is the stream's time from
its entry event to its exit event: its work, any glue it encloses, and any
time the card idled inside it.  A program without spans has no
``report``, and every metric here then reads nothing (None).
"""

from __future__ import annotations

from typing import Optional


def report() -> Optional[dict]:
    """The program's span report, or None where it has no spans."""
    try:
        from raymarchdenoisercuda_torch.utils.timing import report as read
    except ImportError:
        return None
    return read()


def span_ms(trace, name: str, key: str = "device_ms") -> Optional[float]:
    """``key`` ("device_ms", "self_device_ms", "host_ms") of the span
    ``name`` a unit of the window, or None where it never ran."""
    rep = report()
    if rep is None or trace.units <= 0:
        return None
    s = rep["spans"].get(name)
    if not s or not s["count"]:
        return None
    return s[key] / trace.units


def reprojected_pct() -> Optional[float]:
    """The share of the window's pixels, in %, whose history was taken."""
    rep = report()
    if rep is None:
        return None
    c = rep["counters"]
    if not c.get("pixels") or "reprojected_px" not in c:
        return None
    return 100.0 * c["reprojected_px"] / c["pixels"]


def host_syncs(trace, unit_span: str) -> Optional[float]:
    """Synchronising calls a unit (the span ``unit_span``), or None where
    no unit ran; notes where each was made, and every span a unit."""
    rep = report()
    if rep is None or trace.units <= 0 or unit_span not in rep["spans"]:
        return None
    trace.notes.append(f"host syncs by span and call site (the window): "
                       f"{rep['syncs']}")
    trace.notes.append("spans a unit (count, device ms, self device ms, "
                       "host ms): " + "; ".join(
                           f"{name} {s['count'] / trace.units:.3f} "
                           f"{s['device_ms'] / trace.units:.6f} "
                           f"{s['self_device_ms'] / trace.units:.6f} "
                           f"{s['host_ms'] / trace.units:.6f}"
                           for name, s in rep["spans"].items()))
    return rep["counters"]["host_syncs"] / trace.units
