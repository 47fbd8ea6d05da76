"""The program's spans and counters (``utils.timing``).

Off (no ``torch.profiler`` session recording) every call is one shared
null context or nothing: no record, no CUDA event, no ``record_function``.
Under a CPU profiler session, frames of ``FramePipeline`` and steps of
``make_train_step`` (``impl="auto"`` on CPU tensors, 16x24) record every
span of the serving and training layers once a unit, with their parents
and their unit's id, the adjoints' spans under ``rdt.backward``; the spans
are ``user_annotation`` events of the exported Chrome trace.  Self time is
a span's interval less the union of its children's; a new session clears
the last; ``reprojected_px`` is the frames' ``(length > 1).sum()``.  On the
card a synchronising call inside a unit counts under its span (marked
``cuda``).
"""

import json
import threading

import pytest
import torch

from raymarchdenoisercuda_torch.config import (CameraParams, RaymarchParams,
                                               SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import History
from raymarchdenoisercuda_torch.io.generate import orbit_camera
from raymarchdenoisercuda_torch.models.pipeline import (FramePipeline,
                                                        init_train_state,
                                                        make_train_step)
from raymarchdenoisercuda_torch.ops.raymarch import (cornell_camera,
                                                     cornell_scene)
from raymarchdenoisercuda_torch.utils import timing

H, W = 16, 24
CAM = CameraParams(width=W, height=H)
RM = RaymarchParams(max_steps=24, shadow_steps=12)
SV = SVGFParams(iterations=2, radius=1)
FRAMES = 3
STEPS = 2

# span -> its parent
SERVE = {"rdt.frame": None, "rdt.render": "rdt.frame",
         "rdt.denoise": "rdt.frame", "rdt.temporal": "rdt.denoise",
         "rdt.atrous": "rdt.denoise"}
TRAIN = {"rdt.step": None, "rdt.forward": "rdt.step",
         "rdt.render": "rdt.forward", "rdt.denoise": "rdt.forward",
         "rdt.temporal": "rdt.denoise", "rdt.atrous": "rdt.denoise",
         "rdt.backward": "rdt.step", "rdt.optim": "rdt.step"}
ADJOINTS = ("rdt.render.bwd", "rdt.temporal.bwd", "rdt.atrous.bwd")


def annotations(prof, tmp_path_factory):
    """The names of the ``user_annotation`` events of the profiler's
    exported Chrome trace."""
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def profiled(fn):
    """``fn()`` under a CPU profiler session; returns the session's span
    records, its report and the profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return list(timing.RECORDER.records), timing.report(), prof


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    pipe = FramePipeline(cornell_scene(device="cpu"), CAM, RM, SV)
    gen = torch.Generator().manual_seed(3)
    state = dict(hist=History.zeros(H, W, device="cpu"), lengths=[])

    def frames():
        prev = None
        for k in range(FRAMES):
            cam = orbit_camera(k / 16, device="cpu")
            with torch.no_grad():
                _, state["hist"] = pipe(cam, prev, state["hist"], gen)
            state["lengths"].append(state["hist"].length.clone())
            prev = cam

    records, rep, prof = profiled(frames)
    return dict(records=records, report=rep, lengths=state["lengths"],
                annotations=annotations(prof, tmp_path_factory))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    scene = cornell_scene(device="cpu")
    gen = torch.Generator().manual_seed(4)
    step = make_train_step(scene, cornell_camera(device="cpu"),
                           torch.rand(3, H, W, generator=gen), cam_cfg=CAM,
                           rm_params=RM, svgf_params=SV)
    state = dict(st=init_train_state(scene.materials.albedo, H, W, gen))

    def steps():
        for _ in range(STEPS):
            state["st"], _ = step(state["st"])

    records, rep, prof = profiled(steps)
    return dict(records=records, report=rep,
                annotations=annotations(prof, tmp_path_factory))


def by_name(records, name):
    return [r for r in records if r.name == name]


def ancestors(rec):
    out, p = [], rec.parent
    while p is not None:
        out.append(p.name)
        p = p.parent
    return out


# -- off ---------------------------------------------------------------------

def _off_span():
    with timing.span("t.off"):
        pass


def _off_unit():
    with timing.span("t.off", unit=True):
        pass


def _off_spanned():
    assert timing.spanned("t.off")(lambda x: x + 1)(1) == 2


def _off_counters():
    timing.count("t.off", 3)
    timing.count_device("t.off", torch.ones(()))


def _off_backward():
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    timing.span_backward("t.off", (y,), (x,))
    y.sum().backward()


@pytest.mark.parametrize("call", [_off_span, _off_unit, _off_spanned,
                                  _off_counters, _off_backward])
def test_off_records_nothing_and_makes_no_event(call, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while spans are off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(timing._PROFILER, "record_function", refuse)
    r = timing.RECORDER
    before = (list(r.records), dict(r.counters), dict(r.device_counters))
    call()
    assert (list(r.records), dict(r.counters),
            dict(r.device_counters)) == before


def test_off_is_one_shared_null_context():
    a, b = timing.span("a"), timing.span("b", unit=True)
    assert a is b and a is timing._OFF
    assert not timing.tracing()


# -- on: the program's spans -------------------------------------------------

@pytest.mark.parametrize("name", list(SERVE))
def test_a_frame_records_each_span_once(served, name):
    recs = by_name(served["records"], name)
    assert len(recs) == FRAMES
    assert [r.unit for r in recs] == list(range(1, FRAMES + 1))
    for r in recs:
        assert r.t1 >= r.t0
        if SERVE[name] is None:
            assert r.parent is None
        else:
            assert r.parent.name == SERVE[name]
            assert r.parent.unit == r.unit
    assert served["report"]["spans"][name]["count"] == FRAMES


@pytest.mark.parametrize("name", list(TRAIN))
def test_a_step_records_each_span_once(trained, name):
    recs = by_name(trained["records"], name)
    assert len(recs) == STEPS
    assert [r.unit for r in recs] == list(range(1, STEPS + 1))
    for r in recs:
        want = TRAIN[name]
        assert (r.parent.name if r.parent else None) == want
    assert trained["report"]["units"] == STEPS


@pytest.mark.parametrize("name", ADJOINTS)
def test_the_adjoints_sit_under_the_backward(trained, name):
    recs = by_name(trained["records"], name)
    assert {r.unit for r in recs} == set(range(1, STEPS + 1))
    for r in recs:
        assert "rdt.backward" in ancestors(r)
        assert r.unit == r.parent.unit
    s = trained["report"]["spans"][name]
    assert s["device_ms"] > 0 and s["self_device_ms"] > 0


def test_the_training_step_counts_its_fused_temporal_route(trained):
    """Each step's temporal step counts on ``temporal_steps``, and on
    ``temporal_fused`` where it takes the fused route (K3 and its adjoint
    K16; the plain step and its twin on CPU tensors): every step here,
    whose history and motion take no gradient."""
    c = trained["report"]["counters"]
    assert c["temporal_steps"] == STEPS
    assert c["temporal_fused"] == STEPS


@pytest.mark.parametrize("unit,names", [("served", SERVE),
                                        ("trained", TRAIN)])
def test_the_spans_are_in_the_profilers_trace(unit, names, request):
    got = request.getfixturevalue(unit)["annotations"]
    assert set(names) <= got
    if unit == "trained":
        assert set(ADJOINTS) <= got


@pytest.mark.parametrize("name", ["rdt.frame", "rdt.denoise"])
def test_a_parents_device_time_holds_its_childrens(served, name):
    s = served["report"]["spans"][name]
    kids = [served["report"]["spans"][k]["device_ms"]
            for k, p in SERVE.items() if p == name]
    assert s["self_device_ms"] >= 0
    assert s["device_ms"] == pytest.approx(s["self_device_ms"] + sum(kids),
                                           rel=1e-9)


def test_reprojected_px_is_the_frames_count(served):
    c = served["report"]["counters"]
    want = sum(int((n > 1).sum()) for n in served["lengths"])
    assert want > 0
    assert c["reprojected_px"] == want
    assert c["pixels"] == FRAMES * H * W
    assert c["host_syncs"] == 0


# -- on: the recorder --------------------------------------------------------

def test_a_thread_with_no_open_span_takes_the_unit_threads():
    seen = {}

    def other():
        with timing.span("t.other") as s:
            seen["rec"] = s.rec

    def unit():
        with timing.span("t.unit", unit=True):
            with timing.span("t.inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()

    records, _, _ = profiled(unit)
    inner = by_name(records, "t.inner")[0]
    assert seen["rec"].parent is inner and seen["rec"].unit == inner.unit == 1


def test_a_backward_span_covers_autograds_adjoint():
    def run():
        with timing.span("t.unit", unit=True):
            x = torch.rand(64, requires_grad=True)
            y = x * 3.0
            z = y.exp().sin()
            timing.span_backward("t.adjoint", (z,), (y,))
            with timing.span("t.backward"):
                (z.sum() + y.sum()).backward()

    records, rep, _ = profiled(run)
    (adj,) = by_name(records, "t.adjoint")
    assert adj.parent.name == "t.backward" and adj.t1 is not None
    assert rep["spans"]["t.adjoint"]["count"] == 1


def _clock(recorder, name, parent, t0, t1):
    rec = timing._Record(name, parent, 1)
    rec.t0, rec.t1 = t0 / 1e3, t1 / 1e3       # ms on the host clock
    recorder.records.append(rec)
    return rec


@pytest.mark.parametrize("children,self_ms", [
    ([], 10.0),
    ([(1, 3)], 8.0),
    ([(1, 4), (3, 6)], 5.0),                 # overlapping: once
    ([(2, 5), (2, 5)], 7.0),                 # the same interval twice
    ([(1, 9), (2, 3)], 2.0),                 # one inside another
    ([(-2, 3), (8, 12)], 5.0),               # partly outside the parent
])
def test_self_time_is_the_interval_less_its_childrens_union(children,
                                                            self_ms):
    r = timing.SpanRecorder()
    parent = _clock(r, "p", None, 0.0, 10.0)
    for s, e in children:
        _clock(r, "c", parent, s, e)
    got = r.report()["spans"]["p"]
    assert got["device_ms"] == pytest.approx(10.0)
    assert got["self_device_ms"] == pytest.approx(self_ms)
    assert got["host_ms"] == pytest.approx(10.0)


def test_a_span_inside_one_of_its_name_adds_only_self_time():
    r = timing.SpanRecorder()
    outer = _clock(r, "s", None, 0.0, 10.0)
    _clock(r, "s", outer, 2.0, 5.0)
    got = r.report()["spans"]["s"]
    assert got["count"] == 2
    assert got["device_ms"] == pytest.approx(10.0)
    assert got["self_device_ms"] == pytest.approx(10.0)


@pytest.mark.parametrize("between", ["a span while off", "report"])
def test_a_new_session_clears_the_last(between):
    def first():
        with timing.span("t.first", unit=True):
            timing.count("t.n", 2)

    def second():
        with timing.span("t.second", unit=True):
            pass

    if between == "report":
        def both():
            first()
            assert set(timing.report()["spans"]) == {"t.first"}
            second()
        _, rep, _ = profiled(both)
    else:
        profiled(first)
        with timing.span("t.off"):
            pass
        _, rep, _ = profiled(second)
    assert set(rep["spans"]) == {"t.second"}
    assert rep["units"] == 1 and "t.n" not in rep["counters"]


def test_the_report_is_read_once_and_kept():
    _, rep, _ = profiled(lambda: timing.count("t.n", 5))
    assert timing.report() is rep and rep["counters"]["t.n"] == 5


# -- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_a_sync_counts_under_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()

    def run():
        with timing.span("t.unit", unit=True):
            with timing.span("t.inner"):
                y = (x * 2).sum()
                float(y.item())
            y.add_(1)
        x.sum().item()         # outside the unit: not counted

    with torch.profiler.profile():
        run()
    rep = timing.report()
    assert rep["clock"] == "cuda"
    assert rep["counters"]["host_syncs"] == 1
    # the call is this file's, outside the program's package
    assert rep["syncs"] == {"t.inner": {"(outside the program)": 1}}
    assert torch.cuda.get_sync_debug_mode() == 0
    assert rep["spans"]["t.inner"]["device_ms"] > 0
