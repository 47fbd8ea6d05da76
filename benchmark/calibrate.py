"""Readings that the limits of ``correct`` are set from, for one cell at its
own size, on the card, in one process (the set-up's build and context paid
once):

    python3 -m benchmark.calibrate --workload <name> [--seeds 12]
        [--controls 3] [--faults 3] [--seconds 2] [--out FILE]

For each of ``--seeds`` seeds: the program's numbers, as a run of the cell
gives them (set-up, a window of ``--seconds``, the check).  On the first
``--controls`` seeds, the control's: the reference in bfloat16 in the
program's place, judged by the float32 reference, and each lower-precision
path of the program's own that its driver names (``PROGRAM_CONTROLS``).
On the first ``--faults`` seeds, each fault of its driver (``FAULTS``),
planted under the timed path.  One JSON line a reading, to standard output
and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import cell as cells
from . import drivers, timing


def measure(cell, seed, seconds, device, config=None):
    """One seed through the driver as ``run.py`` drives it; returns the
    driver after its check and the numbers."""
    d = drivers.make(config or cell.config, cell.traffic, seed, device)
    cuda = torch.cuda if device == "cuda" else None
    d.setup()
    timing.closed_loop(d.dispatch, seconds, int(cell.traffic["in_flight"]),
                       cuda)
    d.release()
    if cuda is not None:
        cuda.empty_cache()
    return d, d.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.resolve(cells.load_spec(), args.workload)
    mod = drivers.load(cell.config["entry"])
    size = f"{cell.config['width']}x{cell.config['height']}"
    sink = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0, detail=None):
        line = json.dumps({"cell": cell.name, "size": size, "kind": kind,
                           "seed": seed, "numbers": numbers,
                           "seconds": round(time.time() - t0, 2),
                           **({"detail": detail} if detail else {})})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        t0 = time.time()
        d, numbers = measure(cell, seed, args.seconds, "cuda")
        look = getattr(mod, "detail", None)
        emit("program", seed, numbers, t0, look(d) if look else None)
        if i < args.controls:
            t0 = time.time()
            emit("control_reference_bf16", seed, mod.control_numbers(d), t0)
        del d
        for kind, changes in (mod.PROGRAM_CONTROLS.items()
                              if i < args.controls else ()):
            t0 = time.time()
            d, numbers = measure(cell, seed, args.seconds, "cuda",
                                 dict(cell.config, **changes))
            emit(kind, seed, numbers, t0)
            del d
        for name, fault in (mod.FAULTS.items() if i < args.faults else ()):
            t0 = time.time()
            with fault():
                d, numbers = measure(cell, seed, args.seconds, "cuda")
            emit("fault_" + name, seed, numbers, t0)
            del d
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
