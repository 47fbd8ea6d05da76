"""``BENCHMARK.json`` and the files it names: the names, units and sizes
the contract allows, every cell's parts found by name, a new traffic file
found without an edit, and the imports the benchmark may not make."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import cell as cells
from benchmark import drivers, run
from benchmark import traffic as gen

HERE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "raymarchdenoisercuda_tpu"}


@pytest.fixture(scope="module")
def spec():
    return cells.load_spec()


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_units(spec):
    assert set(spec) == TOP_KEYS
    assert 1 <= spec["run_seconds"] <= 51
    assert spec["paths"] == ["benchmark"]
    assert all(one_line(w) for w in spec["command"])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in spec["workloads"]}) == len(
        spec["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(spec["workloads"])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_every_cell_resolves(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    used = set()
    for w in spec["workloads"]:
        c = cells.resolve(spec, w["name"])
        used.add(w["config"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
        for m in c.per_layer:
            assert callable(cells.metric_reader(m["name"]))
            assert m["moves"] in e2e and m["moves"] in reported
        mod = drivers.load(c.config["entry"])
        assert callable(mod.Driver) and callable(mod.control_numbers)
        assert mod.FAULTS and isinstance(mod.PROGRAM_CONTROLS, dict)
        assert gen.part("cameras", c.traffic["camera"]["path"])
        if "target" in c.traffic:
            assert callable(gen.part("targets", c.traffic["target"]).make)
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert (HERE.parent / c["file"]).exists()


def test_a_new_traffic_file_is_found_without_an_edit(spec, tmp_path):
    base = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "kernel_names"):
        shutil.copytree(HERE / sub, base / sub)
    data = json.loads((HERE / "traffic" / "orbit_cornell.json").read_text())
    data["camera"]["period"] = 32
    (base / "traffic" / "orbit_slow.json").write_text(json.dumps(data))
    new = dict(spec, workloads=spec["workloads"] + [
        {"name": "serve_4k_slow", "config": "svgf_serve_4k",
         "traffic": "orbit_slow", "chips": 1, "why": "a test"}])
    c = cells.resolve(new, "serve_4k_slow", base)
    assert c.traffic["camera"]["period"] == 32
    assert c.traffic["name"] == "orbit_slow"


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = imported_top_names(path)
        assert names <= {"__future__", "math", "torch"}, (path, names)
        tree = ast.parse(path.read_text())
        relative = [n.module for n in ast.walk(tree)
                    if isinstance(n, ast.ImportFrom) and n.level > 0]
        assert all(m is None or m in ("denoise", "render")
                   for m in relative), (path, relative)


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["raymarchdenoisercuda_torch.ops",
                                  "raymarchdenoisercuda_tpu_x", "jaxtyping",
                                  "benchmark.run"]) == []
    assert run.forbidden_modules(["raymarchdenoisercuda_tpu.ops.atrous",
                                  "jax.numpy", "flax"]) == [
        "flax", "jax", "raymarchdenoisercuda_tpu"]


def test_a_new_driver_is_found_by_its_entry(tmp_path, monkeypatch):
    (tmp_path / "replay_entry.py").write_text(
        "from benchmark.drivers import Program\n"
        "class Driver(Program):\n"
        "    unit = 'frame'\n"
        "FAULTS = {}\n"
        "PROGRAM_CONTROLS = {}\n"
        "def control_numbers(d):\n"
        "    return {}\n")
    monkeypatch.setattr(drivers, "__path__",
                        list(drivers.__path__) + [str(tmp_path)])
    mod = drivers.load("replay_entry")
    assert mod.Driver.unit == "frame" and issubclass(mod.Driver,
                                                     drivers.Program)
    with pytest.raises(ValueError):
        drivers.load("train_step.py")


def test_every_end_to_end_metric_has_a_value():
    spec = cells.load_spec()
    for w in spec["workloads"]:
        c = cells.resolve(spec, w["name"])
        unit = drivers.load(c.config["entry"]).Driver.unit
        for m in c.end_to_end:
            v = run.end_to_end(m["name"], unit, 2.0, 100, [10.0, 20.0, 30.0],
                               2 ** 30, 12.5)
            assert v > 0, m["name"]
    assert run.end_to_end("frame_ms", "frame", 2.0, 100, [1.0], 0, 0) == 20
    with pytest.raises(KeyError):
        run.end_to_end("tokens_per_s", "frame", 2.0, 100, [1.0], 0, 0)
