"""The cell ``serve_4k_unbounded``: its program at a small size on the CPU
against the unbounded reference, render included (as the bounded cells'
in ``test_bench_reference.py``); its driver's reference is that one; the
temporal step's roofline count; and its four metrics, on a synthetic
report and on a traced run, reading nothing where the spans or counters
are absent.  The test may import the port; the reference does not."""

import sys
import types

import pytest
import torch

from benchmark import cell as cells
from benchmark import drivers, run, spans
from benchmark.reference import denoise_unbounded as ref_denoise
from benchmark.reference import render as ref_render
from benchmark.roofline.peaks import HBM_BYTES_PER_S, least_seconds
from benchmark.roofline.temporal import step_work

H, W = 40, 56
SPEC = cells.load_spec()
CELL = "serve_4k_unbounded"
NEW = ("temporal_gather_span_ms.serve", "temporal_epilogue_span_ms.serve",
       "reprojected_far_pct.serve", "temporal_roofline.serve")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program(seed=3, h=H, w=W):
    c = cells.resolve(SPEC, CELL)
    return drivers.make(dict(c.config, width=w, height=h), c.traffic, seed,
                        "cpu")


def test_the_cell_is_the_unbounded_configuration_on_the_fast_orbit():
    c = cells.resolve(SPEC, CELL)
    assert c.chips == 1
    assert c.config["svgf"]["max_motion"] is None
    assert c.config["entry"] == "frame_pipeline_unbounded"
    bounded = cells.load_json("configs", "svgf_serve_4k")
    for k in ("width", "height", "fov_y", "raymarch", "weight_math",
              "precision"):
        assert c.config[k] == bounded[k], k
    assert {k: v for k, v in c.config["svgf"].items() if k != "max_motion"} \
        == {k: v for k, v in bounded["svgf"].items() if k != "max_motion"}
    slow = cells.load_json("traffic", "orbit_cornell")
    assert c.traffic["camera"] == dict(slow["camera"], period=32)
    for k in ("scene", "in_flight", "warmup"):
        assert c.traffic[k] == slow[k], k
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
            assert m["layer"] == "temporal step" and m["moves"] == "frame_ms"
        elif m.get("workloads") and "serve_4k_cornell" in m["workloads"]:
            assert m["workloads"][-1] == CELL, m["name"]


def test_render_and_denoise_match_the_unbounded_reference():
    from raymarchdenoisercuda_torch.gbuffer import History
    from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
    from raymarchdenoisercuda_torch.ops.raymarch import render_gbuffer
    p = program()
    assert p.svgf.max_motion is None
    hist = History.zeros(H, W, device="cpu")
    ref_hist = ref_denoise.zero_history(H, W, dtype=torch.float32,
                                        device="cpu")
    for k in (5, 6, 7):
        state = p.gen.get_state()
        g = render_gbuffer(p.scene, p.camera(k), p.camera(k - 1), p.gen,
                           cam_cfg=p.cam_cfg, params=p.rm, impl="plain")
        scene = drivers.reference_scene(p.arrays, "cpu")
        cam = drivers.reference_camera(p.traffic, k, "cpu")
        prev = drivers.reference_camera(p.traffic, k - 1, "cpu")
        rg = ref_render.render(scene, cam, prev, p.ref_generator(state),
                               p.ref_cfg(), p.config["raymarch"],
                               block_rows=16)
        for name in drivers.GBUF_PLANES:
            torch.testing.assert_close(getattr(g, name), rg[name],
                                       rtol=1e-6, atol=1e-6, msg=name)
        out, hist = svgf_denoise_frame(g, hist, params=p.svgf,
                                       impl="plain")
        den, ref_hist = ref_denoise.denoise(rg, ref_hist, p.config["svgf"])
        torch.testing.assert_close(out.denoised, den, rtol=1e-5, atol=1e-6)
        for name in ("color", "moments", "length"):
            torch.testing.assert_close(getattr(hist, name), ref_hist[name],
                                       rtol=1e-5, atol=1e-6, msg=name)


def test_the_drivers_reference_is_the_unbounded_one(monkeypatch):
    """The driver's reference frame calls the unbounded reference's
    ``denoise``, and the bounded one's module is restored after."""
    from benchmark.drivers import frame_pipeline
    p = program(h=8, w=12)
    p.setup()
    calls = []
    denoise = ref_denoise.denoise

    def spy(*args):
        calls.append(args)
        return denoise(*args)

    monkeypatch.setattr(ref_denoise, "denoise", spy)
    p.reference_frame(p.last)
    assert len(calls) == 1
    assert frame_pipeline.ref_denoise.__name__ == \
        "benchmark.reference.denoise"


def test_the_steps_roofline_counts_104_bytes_a_pixel():
    nbytes, ops = step_work(1, 1)
    assert nbytes == 104
    nbytes, ops = step_work(3840, 2160)
    assert nbytes == 862_617_600
    assert ops == 201 * 3840 * 2160
    # bytes bound the step: 0.2575 ms at the HBM rate
    assert least_seconds(nbytes, ops) == nbytes / HBM_BYTES_PER_S
    assert least_seconds(nbytes, ops) * 1e3 == pytest.approx(0.2575, abs=1e-4)
    assert step_work(10, 10, False, 0)[1] == (201 - 30 - 29) * 100


def synthetic(monkeypatch, spans_=None, counters=None, units=4):
    """A trace of ``units`` frames of the serving cell whose program report
    holds ``spans_`` and ``counters``."""
    rep = dict(spans={name: dict(count=units, device_ms=ms,
                                 self_device_ms=ms, host_ms=ms)
                      for name, ms in (spans_ or {}).items()},
               counters=dict(counters or {}))
    monkeypatch.setattr(spans, "report", lambda: rep)
    cfg = cells.resolve(SPEC, CELL).config
    return types.SimpleNamespace(units=units, notes=[], config=cfg)


def test_the_metrics_read_a_synthetic_report(monkeypatch):
    trace = synthetic(monkeypatch, {"rdt.temporal": 40.0,
                                    "rdt.temporal.gather": 4.0,
                                    "rdt.temporal.epilogue": 30.0},
                      {"pixels": 1000, "reprojected_px": 900,
                       "reprojected_far_px": 650})
    read = {name: cells.metric_reader(name)(trace) for name in NEW}
    assert read["temporal_gather_span_ms.serve"] == 1.0
    assert read["temporal_epilogue_span_ms.serve"] == 7.5
    assert read["reprojected_far_pct.serve"] == 65.0
    # 0.2575 ms least over 10 ms a frame
    assert read["temporal_roofline.serve"] == pytest.approx(
        100 * 862_617_600 / HBM_BYTES_PER_S * 1e3 / 10.0)
    assert any(n.startswith("roofline temporal") for n in trace.notes)


@pytest.mark.parametrize("name", NEW)
def test_a_metric_reads_nothing_without_its_span_or_counter(monkeypatch,
                                                            name):
    # the bounded route: rdt.temporal, reprojected_px, nothing new
    trace = synthetic(monkeypatch, {"rdt.temporal": 1.4},
                      {"pixels": 1000, "reprojected_px": 900})
    value = cells.metric_reader(name)(trace)
    if name == "temporal_roofline.serve":
        assert value > 0
    else:
        assert value is None
    trace = synthetic(monkeypatch)
    assert cells.metric_reader(name)(trace) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    import raymarchdenoisercuda_torch.utils as utils
    bare = types.ModuleType("raymarchdenoisercuda_torch.utils.timing")
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    monkeypatch.setattr(utils, "timing", bare, raising=False)
    trace = types.SimpleNamespace(units=10, notes=[],
                                  config=cells.resolve(SPEC, CELL).config)
    assert cells.metric_reader(name)(trace) is None


def test_a_traced_run_reads_every_new_metric():
    c = cells.resolve(SPEC, CELL)
    c.config = dict(c.config, width=64, height=48)
    result = run.run_cell(c, 2 ** 31 + 29, 0.3, True, "cpu")["result"]
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["temporal_gather_span_ms.serve"] > 0
    assert m["temporal_epilogue_span_ms.serve"] > 0
    assert m["temporal_span_ms.serve"] > m["temporal_epilogue_span_ms.serve"]
    # a 64-px frame moves well under the bound
    assert m["reprojected_far_pct.serve"] == 0.0
    assert 0 < m["temporal_roofline.serve"] <= 100
    assert m["host_syncs.serve"] == 0.0
