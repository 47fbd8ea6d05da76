"""The per-layer metrics that read the program's spans and counters
(``benchmark/spans.py``): a traced run of a serving and of a training
cell at a small size on the CPU, driven as ``run.py`` drives it, fills the
program's span report, and each new metric of the cell reads a positive
number from it (a count of synchronising calls: a count, 0 on the CPU);
a metric reads nothing (None) from a window where its span never ran (the
training metrics from a serving window, the serving unit's from a
training window, every one from a window without the program's spans);
and every one reads nothing, without raising, from a program that has no
spans."""

import sys
import types

import pytest
import torch

from benchmark import cell as cells
from benchmark import run

H, W = 48, 64
SECONDS = 0.3
SPEC = cells.load_spec()
NEW = {"serve": ["enqueue_ms.serve", "render_span_ms.serve",
                 "temporal_span_ms.serve", "atrous_span_ms.serve",
                 "denoise_self_ms.serve", "reprojected_pct.serve",
                 "host_syncs.serve"],
       "train": ["enqueue_ms.train", "forward_span_ms.train",
                 "backward_self_ms.train", "render_bwd_span_ms.train",
                 "temporal_bwd_span_ms.train", "atrous_bwd_span_ms.train",
                 "optim_span_ms.train", "host_syncs.train"]}
CELL = {"serve": "serve_4k_cornell", "train": "train_4k_cornell"}
COUNTS = {"host_syncs.serve", "host_syncs.train"}
SHARED = {"render_span_ms.serve", "temporal_span_ms.serve",
          "atrous_span_ms.serve", "denoise_self_ms.serve",
          "reprojected_pct.serve"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(kind):
    c = cells.resolve(SPEC, CELL[kind])
    c.config = dict(c.config, width=W, height=H)
    return run.run_cell(c, 2 ** 31 + 19, SECONDS, True, "cpu")["result"]


@pytest.fixture(scope="module")
def windows():
    """Each kind's traced result, and what every new reader reads from
    the span report that its window left."""
    out = {}
    for kind in ("serve", "train"):
        result = traced(kind)
        trace = types.SimpleNamespace(units=result["attempted"], notes=[])
        out[kind] = dict(result=result, trace=trace, read={
            name: cells.metric_reader(name)(trace)
            for names in NEW.values() for name in names})
    return out


def test_the_new_metrics_are_the_benchmarks():
    listed = {m["name"]: m for m in SPEC["per_layer"]}
    for kind, names in NEW.items():
        for name in names:
            assert listed[name]["workloads"] == [
                w["name"] for w in SPEC["workloads"]
                if w["name"].startswith(kind)], name


@pytest.mark.parametrize("kind,name", [(k, n) for k, ns in NEW.items()
                                       for n in ns])
def test_a_metric_reads_its_span(windows, kind, name):
    w = windows[kind]
    assert w["result"]["correct"]
    value = w["result"]["metrics"][name]["value"]
    assert value == w["read"][name]
    if name in COUNTS:
        assert value == 0.0
    else:
        assert value > 0
    if name == "reprojected_pct.serve":
        assert value <= 100.0


@pytest.mark.parametrize("kind,name", [(k, n) for k, ns in NEW.items()
                                       for n in ns])
def test_a_metric_reads_nothing_where_its_span_never_ran(windows, kind,
                                                         name):
    other = "train" if kind == "serve" else "serve"
    if name in SHARED:
        # a training step renders and denoises through the same spans
        assert windows[other]["read"][name] > 0
    else:
        assert windows[other]["read"][name] is None


def test_a_window_without_the_programs_spans_reads_nothing():
    from raymarchdenoisercuda_torch.utils.timing import span
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("another.unit", unit=True):
            torch.ones(8).sum()
    trace = types.SimpleNamespace(units=10, notes=[])
    for names in NEW.values():
        for name in names:
            assert cells.metric_reader(name)(trace) is None, name


@pytest.mark.parametrize("name", [n for ns in NEW.values() for n in ns])
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    import raymarchdenoisercuda_torch.utils as utils
    bare = types.ModuleType("raymarchdenoisercuda_torch.utils.timing")
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    monkeypatch.setattr(utils, "timing", bare, raising=False)
    trace = types.SimpleNamespace(units=10, notes=[])
    assert cells.metric_reader(name)(trace) is None
