"""``utils.timing.trace``, the counterpart of the JAX package's ``trace``:
the work inside the block is written as a Chrome trace that holds its
named spans and operators (here on the CPU; on the card it also holds the
kernels, ``utils/profile.py --trace``)."""

import json

import pytest
import torch

from raymarchdenoisercuda_torch.utils import profile as rdt_profile
from raymarchdenoisercuda_torch.utils.timing import trace


def test_trace_writes_a_chrome_trace_with_the_named_ops(tmp_path):
    a = torch.rand(64, 64)
    with trace(str(tmp_path / "tr"), name="step") as prof:
        with torch.profiler.record_function("rdt_denoise_step"):
            b = torch.mm(a, a).relu()
    assert prof is not None and b.shape == (64, 64)
    path = tmp_path / "tr" / "step.json"
    assert path.is_file()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"rdt_denoise_step", "aten::mm", "aten::relu"} <= names


def test_profile_takes_a_trace_directory(tmp_path, capsys):
    """``utils/profile.py`` parses ``--trace DIR`` for its runners (and then,
    without a card, stops as it does without it) and refuses it for the
    paths that time under a profiler of their own."""
    if torch.cuda.is_available():
        pytest.skip("on the card this would profile a 1080p step")
    assert rdt_profile.main(["serve", "--trace", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        rdt_profile.main(["box", "--trace", str(tmp_path)])
