"""Finding a cell's parts by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each is a file found by
its name: ``configs/<config>.json`` and ``traffic/<traffic>.json`` beside
this module.  The configuration's ``entry`` names its driver,
``drivers/<entry>.py``; the traffic's camera path and target name modules
of ``cameras/`` and ``targets/``.  A per-layer metric is
``metrics/<name>.py``, a module with ``read(trace) -> float | None``.  So a
later change adds a configuration, a traffic mix, a metric or a new kind
of any of them by adding a file and an entry, and edits no file that is
already here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with its "name"
    traffic: dict         # traffic/<traffic>.json, with its "name"
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    """``<base>/<kind>/<name>.json`` with its name added."""
    with open(base / kind / f"{name}.json") as f:
        data = json.load(f)
    data["name"] = name
    return data


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: every cell when it
    names no ``workloads``."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str, base: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json("configs", w["config"], base),
        traffic=load_json("traffic", w["traffic"], base),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)])


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``<base>/metrics/<name>.py`` (a name may
    hold dots, so the file is loaded by path, not imported by name)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_layers(base: Path = HERE) -> dict:
    """``{layer: [regular expressions]}`` from ``kernel_names/*.txt``: the
    layer is a file's name up to its first dot, so ``atrous.fused.txt``
    adds patterns to the layer ``atrous``; one pattern a line, ``#``
    starts a comment.  A kernel that matches no pattern is PyTorch's own
    (the glue)."""
    layers: dict = {}
    for path in sorted((base / "kernel_names").glob("*.txt")):
        pats = layers.setdefault(path.name.split(".")[0], [])
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                pats.append(line)
    return layers

