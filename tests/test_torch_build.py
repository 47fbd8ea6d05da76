"""The ctypes declarations of the CUDA kernels' C entry points.

``ops/cuda/_build.py`` declares the argument types of every ``rdt_*``
function the ``.cu`` sources export.  A missing or wrong declaration makes
ctypes pass a pointer as a 32-bit int, which faults on the card only; this
check reads the sources here, without a compiler.
"""

import ctypes
import re

import pytest

from raymarchdenoisercuda_torch.ops.cuda import _build

_EXPORT = re.compile(r'extern "C" int (rdt_\w+)\(([^)]*)\)', re.S)


def _exports():
    found = {}
    for src in _build.sources():
        for name, params in _EXPORT.findall(src.read_text()):
            found[name] = tuple(
                ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params.split(","))
    return found


def test_every_entry_point_is_declared():
    assert set(_exports()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_declared_argument_types_match_the_source(name):
    assert _build.SIGNATURES[name] == _exports()[name]
