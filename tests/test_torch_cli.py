"""The port's case runner and CLI, mirroring ``tests/test_utils_cli.py``:
registration, full-match regex, the failing-case report, ``-h`` and an
unknown option, and the filter cases run on the CPU (``device="cpu"``).
The cases need no tolerance: each passes or fails by its own asserts."""

import pytest

from raymarchdenoisercuda_torch import cli
from raymarchdenoisercuda_torch import testing as rt


@pytest.fixture(autouse=True)
def clean_registry():
    saved = dict(rt.registered_funcs)
    rt.registered_funcs.clear()
    yield
    rt.registered_funcs.clear()
    rt.registered_funcs.update(saved)


def test_case_registration_and_regex_run():
    calls = []

    @rt.case_("ALPHA")
    def a():
        calls.append("a")

    @rt.case_("ALPHA_TWO")
    def a2():
        calls.append("a2")

    @rt.skip("SKIPPED")
    def s():
        calls.append("s")

    @rt.case_
    def bare():
        calls.append("bare")

    lines = []
    assert rt.run("ALPHA", out=lines.append)
    # full-match semantics: ALPHA only, not ALPHA_TWO
    assert calls == ["a"]
    assert "SKIPPED" not in rt.registered_funcs
    assert "bare" in rt.registered_funcs
    assert lines[0] == "Available tests:"
    assert any(l.startswith("\tPassed with ") and l.endswith(" ms")
               for l in lines)


def test_failing_case_reports_fail():
    @rt.case_("BOOM")
    def b():
        raise RuntimeError("exploded")

    @rt.case_("FINE")
    def f():
        pass

    lines = []
    assert not rt.run(".*", out=lines.append)
    assert "\tFail with exploded" in lines
    assert "Running test FINE" in lines      # the runner goes on


def test_cli_help_and_unknown(capsys):
    assert cli.main(["-h"]) == 0
    assert "-t [label]" in capsys.readouterr().out
    assert cli.main([]) == 0
    capsys.readouterr()
    assert cli.main(["--bogus"]) == 2
    assert "Unknown option: --bogus" in capsys.readouterr().err


def test_cli_registers_the_reference_cases():
    cli._register_builtin_cases(cli.resolve_device("cpu"))
    assert list(rt.registered_funcs) == [
        "FILTER_BASELINE", "FILTER_TILED", "SVGF_SPATIAL", "RAYMARCH",
        "TEMPORAL", "FILTER_CROSS", "SHARDED_SPATIAL", "DEVICE_STATS",
        "IMAGE", "DENOISE_CORNELL"]


def test_cli_runs_filter_cases_on_the_cpu(capsys):
    assert cli.main(["-t", "FILTER_(BASELINE|TILED)"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("Passed with") == 2
    assert "Running test FILTER_CROSS" not in out


def test_cli_fixture_cases_fail_without_the_fixture(capsys, monkeypatch):
    monkeypatch.delenv("RDT_REFERENCE_ROOT", raising=False)
    assert cli.main(["-t", "IMAGE|DENOISE_CORNELL"], device="cpu") == 1
    out = capsys.readouterr().out
    assert out.count("Fail with missing fixture") == 2
