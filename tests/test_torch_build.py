"""The ctypes declarations of the CUDA kernels' C entry points, and the
compiled scenes of K7, K8, K13 and K15.

``ops/cuda/_build.py`` declares the argument types of every ``rdt_*``
function the ``.cu`` sources export.  A missing or wrong declaration makes
ctypes pass a pointer as a 32-bit int, which faults on the card only; this
check reads the sources here, without a compiler.

K7 (``rdt_march``), K8 (``rdt_shadow_shade``), K13 (``rdt_shadow``) and
K15 (``rdt_cone_seed``, ``rdt_cone_seed_camera``) are compiled for the
primitive counts of the scenes in
``raymarch_cuda.SHADE_SCENES``; the
wrappers pass the key of the instantiation and each C entry point maps
each key to a template instantiation.  The tables are held to each other
by parsing the source, and the wrappers' choice is checked on CPU scenes.
"""

import ctypes
import re

import pytest

from raymarchdenoisercuda_torch.ops import raymarch
from raymarchdenoisercuda_torch.ops.cuda import _build
from raymarchdenoisercuda_torch.ops.raymarch_cuda import (SHADE_SCENES,
                                                          scene_key)

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


# arguments added to entry points after they were first declared: the
# shading pass's, the march's, the shadow pass's and the cone seed's
# instantiation keys, the cone seed's delta and base pointers, and the
# clamped-gather adjoint's float64 scratch with its plane count; the cone
# seed's camera route (its scratch and key); and the clamped gather's and
# its adjoint's stack layout (texel stride)
@pytest.mark.parametrize("name,index,ctype", [
    ("rdt_shadow_shade", 13, ctypes.c_int),
    ("rdt_march", 9, ctypes.c_int),
    ("rdt_shadow", 6, ctypes.c_int),
    ("rdt_cone_seed", 3, ctypes.c_void_p),
    ("rdt_cone_seed", 4, ctypes.c_void_p),
    ("rdt_cone_seed", 7, ctypes.c_int),
    ("rdt_cone_seed_camera", 5, ctypes.c_void_p),
    ("rdt_cone_seed_camera", 8, ctypes.c_int),
    ("rdt_clamped_gather_bwd", 4, ctypes.c_void_p),
    ("rdt_clamped_gather_bwd", 9, ctypes.c_int),
    ("rdt_clamped_gather", 6, ctypes.c_int),
    ("rdt_clamped_gather_bwd", 10, ctypes.c_int)],
    ids=["shade scene_key", "march scene_key", "shadow scene_key",
         "cone delta", "cone base", "cone scene_key", "cone camera scratch",
         "cone camera scene_key", "gather_bwd scratch", "gather_bwd P",
         "clamped gather layout", "clamped gather_bwd layout"])
def test_added_arguments_are_declared(name, index, ctype):
    assert _build.SIGNATURES[name][index] is ctype
    assert _exports()[name][index] is ctype


def _switch_cases(macro):
    """``{key: counts}`` of the switch whose cases call ``macro`` in
    ``raymarch.cu``."""
    case = re.compile(r"case (\d+): return \(int\)" + macro
                      + r"\((-?\d+), (-?\d+), (-?\d+)\);")
    src = (_build._SRC_DIR / "raymarch.cu").read_text()
    return {int(k): tuple(int(v) for v in counts)
            for k, *counts in case.findall(src)}


def test_shade_keys_match_the_compiled_scenes():
    """rdt_shadow_shade's switch maps key 0 to the runtime-count
    instantiation (-1, -1, -1) and key k to ``SHADE_SCENES[k - 1]``."""
    assert _switch_cases("RDT_SHADE") == {
        0: (-1, -1, -1), **{k + 1: c for k, c in enumerate(SHADE_SCENES)}}


def test_shadow_keys_match_the_compiled_scenes():
    """rdt_shadow's switch (K13) maps the keys as rdt_shadow_shade's
    does."""
    assert _switch_cases("RDT_SHADOW") == _switch_cases("RDT_SHADE")
    assert _switch_cases("RDT_SHADOW") == {
        0: (-1, -1, -1), **{k + 1: c for k, c in enumerate(SHADE_SCENES)}}


def test_march_keys_match_the_compiled_scenes():
    """rdt_march's switch (K7, seeded or not) maps the keys as
    rdt_shadow_shade's does: one list of compiled scenes serves both."""
    assert _switch_cases("RDT_MARCH") == {
        0: (-1, -1, -1), **{k + 1: c for k, c in enumerate(SHADE_SCENES)}}


def test_cone_keys_match_the_compiled_scenes():
    """K15's switch (both routes: ``launch_cone_key``) maps the keys as
    rdt_shadow_shade's does."""
    assert _switch_cases("RDT_CONE") == {
        0: (-1, -1, -1), **{k + 1: c for k, c in enumerate(SHADE_SCENES)}}


@pytest.mark.parametrize("make,key", [
    (lambda: raymarch.cornell_scene(device="cpu"), 1),
    (lambda: raymarch.random_scene(seed=3, device="cpu"), 2),
    (lambda: raymarch.random_scene(n_spheres=7, n_boxes=4, seed=5,
                                   device="cpu"), 0),
    (lambda: raymarch.random_scene(n_spheres=1, n_boxes=3, n_materials=6,
                                   seed=1, device="cpu"), 1)],
    ids=["cornell", "random", "odd", "cornell-counts"])
def test_shade_scene_key_follows_the_counts(make, key):
    """The key depends on the counts alone: a random scene of the Cornell
    box's counts runs the Cornell instantiation."""
    assert scene_key(make()) == key
