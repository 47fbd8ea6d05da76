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
import importlib.util
import itertools
import re
from pathlib import Path

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
# its adjoint's stack layout (texel stride); the bf16 level forward's
# σ-denominator output (its fused form); the gather adjoint's workspace
# and its size (the scatter route past max_motion 59); the à-trous
# adjoints' form (K14 and K2/K2b staged or through the caches)
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
    ("rdt_clamped_gather_bwd", 10, ctypes.c_int),
    ("rdt_atrous_level_bf16", 6, ctypes.c_void_p),
    ("rdt_gather_bwd", 11, ctypes.c_void_p),
    ("rdt_gather_bwd", 12, ctypes.c_int),
    ("rdt_atrous_bwd", 13, ctypes.c_int),
    ("rdt_atrous_bwd_stored", 12, ctypes.c_int)],
    ids=["shade scene_key", "march scene_key", "shadow scene_key",
         "cone delta", "cone base", "cone scene_key", "cone camera scratch",
         "cone camera scene_key", "gather_bwd scratch", "gather_bwd P",
         "clamped gather layout", "clamped gather_bwd layout",
         "bf16 level sden_out", "gather_bwd workspace",
         "gather_bwd workspace ints", "atrous_bwd staged",
         "atrous_bwd_stored staged"])
def test_added_arguments_are_declared(name, index, ctype):
    assert _build.SIGNATURES[name][index] is ctype
    assert _exports()[name][index] is ctype


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, imported by its path."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _adjoint_name(kernel, R, staged, tile):
    """The mangled name nvcc gives an instantiation of K14
    (atrous_bwd_kernel<R, STAGED, TILE>) or K2/K2b
    (atrous_bwd_stored[_staged]_kernel<WT, R, TILE>) in atrous.cu's
    anonymous namespace."""
    r = f"n{-R}" if R < 0 else str(R)
    if kernel == "K14":
        return (f"_ZN12_GLOBAL__N_117atrous_bwd_kernelILi{r}ELb{int(staged)}"
                f"ELb{int(tile)}EEEvPKfS2_S2_S2_S2_S2_S2_S2_PfS3_"
                f"12AtrousParams10AtrousTileS2_")
    wt = "13__nv_bfloat16" if kernel == "K2" else "f"
    body = "31atrous_bwd_stored_staged" if staged else "24atrous_bwd_stored"
    return (f"_ZN12_GLOBAL__N_1{body}_kernelI{wt}Li{r}ELb{int(tile)}EEEvPKT_"
            f"PKfS6_S6_PfS7_iiii10AtrousTile")


def _ptxas_report(entries):
    """ptxas -v's report of ``{name: (registers, stack, spill stores,
    spill loads)}``."""
    lines = []
    for name, (regs, stack, st, ld) in entries.items():
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    {stack} bytes stack frame, {st} bytes spill stores, "
                  f"{ld} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, 460 bytes cmem[0]"]
    return "\n".join(lines) + "\n"


def test_phase2_sees_the_adjoints_instantiations():
    """chip_smoke.py's phase 2 reads K14's and K2/K2b's instantiations from
    ptxas's report by their mangled names: the staged forms past radius 2
    (K14 at 3, 4 and any radius, K2/K2b at 3 and any radius) among them.
    A report that lacks one fails; local memory in any of them is
    returned for phase 2 to fail on."""
    smoke = _chip_smoke()
    entries = {}
    for kernel, forms in smoke.ADJOINT_FORMS.items():
        for (R, staged), tile in itertools.product(sorted(forms),
                                                   (False, True)):
            name = _adjoint_name(kernel, R, staged, tile)
            assert smoke.adjoint_instantiation(name) == (kernel, R, staged,
                                                         tile)
            entries[name] = (56, 0, 0, 0)
    assert (3, True) in smoke.ADJOINT_FORMS["K14"]
    assert (4, True) in smoke.ADJOINT_FORMS["K14"]
    assert (-1, True) in smoke.ADJOINT_FORMS["K2b"]
    report = _build.parse_resources(_ptxas_report(entries))
    assert report == entries
    assert smoke.adjoint_resources(report) == []
    spilled = dict(report)
    spilled[_adjoint_name("K14", 3, True, False)] = (64, 8, 8, 8)
    spilled[_adjoint_name("K2", -1, True, True)] = (40, 16, 0, 0)
    assert sorted(smoke.adjoint_resources(spilled)) == [
        "K14 r3 staged", "K2 any r staged tile"]
    missing = dict(report)
    del missing[_adjoint_name("K2b", 3, True, False)]
    with pytest.raises(AssertionError, match="K2b instantiations"):
        smoke.adjoint_resources(missing)
    assert smoke.adjoint_instantiation(
        "_ZN12_GLOBAL__N_122atrous_bwd_bf16_kernelILi3ELb1ELb0EEEvPKf") \
        is None


# the mangled names nvcc gives K10's and K11's 1-D passes,
# pass_y_kernel<GAUSS> and pass_x_kernel<GAUSS> (filters.cu's anonymous
# namespace), and the forms phase 2 prints and fails on
@pytest.mark.parametrize("name,form", [
    ("_ZN12_GLOBAL__N_113pass_y_kernelILb0EEEvPKfPfiiiS2_",
     "K10 pass along y"),
    ("_ZN12_GLOBAL__N_113pass_y_kernelILb1EEEvPKfPfiiiS2_",
     "K11 pass along y"),
    ("_ZN12_GLOBAL__N_113pass_x_kernelILb0EEEvPKfPfiiiS2_i",
     "K10 pass along x"),
    ("_ZN12_GLOBAL__N_113pass_x_kernelILb1EEEvPKfPfiiiS2_i",
     "K11 pass along x")])
def test_phase2_names_the_filter_passes(name, form):
    smoke = _chip_smoke()
    assert smoke.pass_form(smoke.K1011_PASS.search(name)) == form
    assert smoke.K1011_PASS.search(
        "_ZN12_GLOBAL__N_115sep_pass_kernelILb1ELb0EEEvPKfPfiiiS2_") is None


# the mangled names nvcc gives K3's instantiations,
# temporal_kernel<TILE, PX, CLAMPED> (temporal.cu's anonymous namespace),
# and the forms phase 2 prints and requires
@pytest.mark.parametrize("name,form", [
    ("_ZN12_GLOBAL__N_115temporal_kernelILb0ELi1ELb0EEEvPKf", "K3"),
    ("_ZN12_GLOBAL__N_115temporal_kernelILb1ELi1ELb0EEEvPKf", "K3 tile/K3b"),
    ("_ZN12_GLOBAL__N_115temporal_kernelILb0ELi1ELb1EEEvPKf",
     "K3 unbounded")])
def test_phase2_names_the_temporal_forms(name, form):
    smoke = _chip_smoke()
    assert smoke.k3_form(smoke.K3_MANGLED.search(name)) == form
    assert smoke.K3_MANGLED.search(
        "_ZN12_GLOBAL__N_119temporal_bwd_kernelEPKf") is None


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
