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


def test_ptxas_report_is_parsed():
    """The resource report that chip_smoke.py reads for local memory: each
    entry function's registers, stack and spill bytes, in ptxas -v's
    layout."""
    text = """\
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 1 barriers, 460 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    24 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, 460 bytes cmem[0]
"""
    assert _build.parse_resources(text) == {"_Z1aPf": (58, 0, 0, 0),
                                            "_Z1bPf": (64, 24, 20, 24)}
