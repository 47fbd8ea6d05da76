"""``temporal_fused_pct.train``: a traced training window at a small size
on the CPU, driven as ``run.py`` drives it, reads 100 (every step's
temporal step takes the fused route: its history and motion take no
gradient); a serving window, whose step counts neither counter, and a
program without spans read nothing (None), without raising."""

import types

import pytest
import torch

from benchmark import cell as cells
from benchmark import run, spans

H, W = 48, 64
SECONDS = 0.3
SPEC = cells.load_spec()
NAME = "temporal_fused_pct.train"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced_read(cell_name):
    c = cells.resolve(SPEC, cell_name)
    c.config = dict(c.config, width=W, height=H)
    result = run.run_cell(c, 2 ** 31 + 23, SECONDS, True, "cpu")["result"]
    trace = types.SimpleNamespace(units=result["attempted"], notes=[])
    return result, cells.metric_reader(NAME)(trace)


def test_the_metric_is_the_training_cells():
    m = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert m["workloads"] == [w["name"] for w in SPEC["workloads"]
                              if w["name"].startswith("train")]
    assert m["layer"] == "temporal step" and m["moves"] == "step_ms"


def test_a_training_window_reads_100():
    result, value = traced_read("train_4k_cornell")
    assert result["correct"] and result["attempted"] > 0
    assert value == 100.0


def test_a_serving_window_reads_nothing():
    _, value = traced_read("serve_4k_cornell")
    assert value is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "report", lambda: None)
    reader = cells.metric_reader(NAME)
    assert reader(types.SimpleNamespace(units=3, notes=[])) is None
