"""``temporal_unbounded_fused_pct.serve``: a traced window of the cell
``serve_4k_unbounded`` at a small size on the CPU, driven as ``run.py``
drives it, reads 100 (every frame's unbounded step takes the fused route;
on the CPU its plain twin, which counts the same); a bounded serving
window, which counts neither counter, a program without the fused
route's counter and a program without spans read nothing (None), without
raising."""

import types

import pytest
import torch

from benchmark import cell as cells
from benchmark import run, spans

H, W = 48, 64
SECONDS = 1.0
SPEC = cells.load_spec()
NAME = "temporal_unbounded_fused_pct.serve"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced_read(cell_name):
    c = cells.resolve(SPEC, cell_name)
    c.config = dict(c.config, width=W, height=H)
    result = run.run_cell(c, 2 ** 31 + 37, SECONDS, True, "cpu")["result"]
    trace = types.SimpleNamespace(units=result["attempted"], notes=[])
    return result, cells.metric_reader(NAME)(trace)


def test_the_metric_is_the_unbounded_cells():
    m = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert m["workloads"] == ["serve_4k_unbounded"]
    assert m["layer"] == "temporal step" and m["moves"] == "frame_ms"
    assert (m["unit"], m["better"], m["source"]) == (
        "%", "higher", "program_counter")


def test_an_unbounded_window_reads_100():
    result, value = traced_read("serve_4k_unbounded")
    assert result["correct"] and result["attempted"] > 0
    assert value == 100.0


def test_a_bounded_serving_window_reads_nothing():
    _, value = traced_read("serve_4k_cornell")
    assert value is None


def test_a_program_without_the_fused_counter_reads_nothing(monkeypatch):
    rep = dict(spans={}, counters={"temporal_unbounded": 4})
    monkeypatch.setattr(spans, "report", lambda: rep)
    reader = cells.metric_reader(NAME)
    assert reader(types.SimpleNamespace(units=4, notes=[])) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "report", lambda: None)
    reader = cells.metric_reader(NAME)
    assert reader(types.SimpleNamespace(units=3, notes=[])) is None
