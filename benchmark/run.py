"""Run one cell of the benchmark of ``raymarchdenoisercuda_torch``.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Sets up the cell's program from its configuration and traffic
(``BENCHMARK.json`` names them), runs the traffic's warm-up, measures for
``--seconds`` seconds in a closed loop, then checks what the window
produced against the plain reference and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics read from the
profiler's trace, with ``breakdown``), ``device`` and, last, ``checks``:
each number compared, with its limit.  The same numbers are the last lines
of standard error.

The kernels build into the checkout's ``build/torch_ext/`` on the first
run (the program's own build); later runs load them.  Exits with a code
other than 0, and prints no result, without the cards, or if JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import timing

PROCESS_START = timing.process_start_time()

FORBIDDEN = ("jax", "jaxlib", "flax", "raymarchdenoisercuda_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level modules among ``names`` (default: those
    loaded in this process), each name up to its first dot compared
    whole."""
    loaded = {name.split(".", 1)[0] for name in
              (list(sys.modules) if names is None else names)}
    return sorted(loaded.intersection(FORBIDDEN))


def card_name_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def end_to_end(name: str, unit: str, wall: float, units: int, steps,
               peak: int, setup_s: float) -> float:
    """The end-to-end metric ``name`` of a window of ``units`` units of
    ``unit`` ("frame", "step") in ``wall`` seconds: ``<unit>_ms`` the
    window's time over its units, ``<unit>_ms_p95`` the 95th percentile of
    all intervals between consecutive completions (``steps``, ms),
    ``peak_mem_gib`` and ``setup_s``."""
    if name == f"{unit}_ms":
        return wall * 1e3 / units
    if name == f"{unit}_ms_p95":
        return timing.percentile(steps, 95)
    if name == "peak_mem_gib":
        return peak / 2 ** 30
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} for {unit}s")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             setup_from: float = PROCESS_START) -> dict:
    """Set up, measure and check one cell; returns the result, its notes
    and its check rows.  ``device`` "cpu" runs the plain versions (the
    tests drive a cell so at a small size)."""
    import torch

    from . import cell as cells
    from . import check, drivers
    from . import trace as tracing

    cuda = torch.cuda if device == "cuda" else None
    t_harness = time.time()
    driver = drivers.make(cell.config, cell.traffic, seed, device)
    t_built = time.time()
    driver.setup()
    if cuda is not None:
        cuda.synchronize()
        cuda.reset_peak_memory_stats()
    t_window = time.time()
    setup_s = t_window - setup_from
    notes = [f"setup: {t_harness - setup_from:.3f} s to the harness "
             f"(interpreter, imports), {t_built - t_harness:.3f} s building "
             f"the program's objects (CUDA context), {t_window - t_built:.3f}"
             f" s of warm-up {driver.unit}s (the kernels built or loaded on "
             f"the first)"]
    in_flight = int(cell.traffic["in_flight"])

    def window():
        return timing.closed_loop(driver.dispatch, seconds, in_flight, cuda)

    events = None
    if trace:
        (wall, units, steps), events = tracing.profile(window)
    else:
        wall, units, steps = window()
    peak = cuda.max_memory_allocated() if cuda is not None else 0
    if units < 2:
        raise RuntimeError(f"the window completed {units} {driver.unit}s")

    metrics = {}
    dev = {"platform": "gpu" if cuda is not None else "cpu",
           "kind": cuda.get_device_name(0) if cuda is not None else "cpu",
           "count": cell.chips if cuda is not None else 0,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = tracing.Trace(events, units, cell.config, cells.kernel_layers())
        del events
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        breakdown = tr.breakdown()
        notes += tr.notes
        notes.append(f"trace: {len(tr.device)} device operations in the "
                     f"window, written and read in "
                     f"{time.time() - t_window - wall:.3f} s")
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(
                m["name"], driver.unit, wall, units, steps, peak, setup_s),
                "unit": m["unit"]}

    driver.release()
    if cuda is not None:
        cuda.empty_cache()
    numbers = driver.check()
    notes = driver.notes + notes
    correct, rows = check.verdict(numbers, cell.config.get("limits", {}))
    result = dict(correct=correct, attempted=units,
                  failed=sum(1 for r in rows if not r[3]), metrics=metrics,
                  device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the numbers compared, each beside its limit, last
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in rows}
    return {"result": result, "notes": notes, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import cell as cells
    cell = cells.resolve(cells.load_spec(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"runs without JAX", file=sys.stderr)
        return 3
    print(f"card: {card_name_power()}")
    for line in out["notes"]:
        print(line)
    for name, value, limit, ok in out["rows"]:
        print(f"check {name}: {value!r} (limit {limit!r}) "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
