"""The port's tiling model (``utils/tiling.py``) against the JAX package's
(``raymarchdenoisercuda_tpu/utils/tiling.py``) and the kernels' sources,
and ``utils.timing.Timer``.

Spacing, halo radius, tile extent and the halo-exchange bytes a rank are
the same functions in both packages: equal for every argument here.  The
shared-memory budget is the port's own (the JAX package budgets VMEM row
bands): it is held to the tile constants parsed from
``ops/cuda/atrous_level.cuh`` and ``atrous.cu`` and to the staged
neighbourhood of ``Lattice`` (r lattice rows, r·min(s, 64) columns a
side)."""

import re
import time

import pytest
import torch

from raymarchdenoisercuda_tpu.utils import tiling as jtiling
from raymarchdenoisercuda_torch.ops.cuda import _build
from raymarchdenoisercuda_torch.utils import tiling
from raymarchdenoisercuda_torch.utils.timing import Timer


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("level", [0, 1, 4, 7])
def test_spacing_halo_extent_match_jax(radius, level):
    assert tiling.spacing(level) == jtiling.spacing(level)
    assert tiling.halo_radius(radius, level) == jtiling.halo_radius(
        radius, level)
    for block in (8, 64, 112):
        assert tiling.tile_extent(radius, level, block) == \
            jtiling.tile_extent(radius, level, block)


@pytest.mark.parametrize("tile", [(540, 960), (8, 3840), (1080, 1920)])
@pytest.mark.parametrize("radius,planes,nbytes", [(1, 9, 4), (2, 4, 4),
                                                  (3, 9, 2)])
def test_halo_bytes_match_jax(tile, radius, planes, nbytes):
    got = tiling.halo_budget(*tile, radius, 5, n_planes=planes,
                             dtype_bytes=nbytes)
    want = jtiling.ici_budget(*tile, radius, 5, n_planes=planes,
                              dtype_bytes=nbytes)
    assert [b.halo_bytes for b in got] == [b.ici_bytes for b in want]
    assert [(b.level, b.spacing, b.halo) for b in got] == [
        (b.level, b.spacing, b.halo) for b in want]


def _constants():
    src = {p.name: p.read_text() for p in _build.headers() + _build.sources()}
    k1 = re.search(r"constexpr int K1_TW = (\d+), K1_TY = (\d+), "
                   r"K1_PY = (\d+)", src["atrous_level.cuh"])
    k14 = re.search(r"constexpr int K14_TW = (\d+), K14_TR = (\d+)",
                    src["atrous.cu"])
    return (int(k1[1]), int(k1[2]) * int(k1[3])), (int(k14[1]), int(k14[2]))


def test_tile_constants_are_the_kernels():
    k1, k14 = _constants()
    assert k1 == k14 == (tiling.TILE_COLS, tiling.TILE_ROWS)


@pytest.mark.parametrize("kernel", sorted(tiling.STAGED_PIXEL_BYTES))
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_smem_budget_is_the_lattice_tile(kernel, radius):
    """Staged entries = (8 + 2r)·(64 + 2r·min(s, 64)), lattice_entries of
    atrous_common.cuh, times the kernel's bytes a pixel."""
    px = tiling.STAGED_PIXEL_BYTES[kernel]
    for b in tiling.smem_budget(radius, 8, kernel):
        s = 1 << b.level
        assert (b.staged_rows, b.staged_cols) == (8 + 2 * radius,
                                                  64 + 2 * radius * min(s, 64))
        assert b.smem_bytes == b.staged_rows * b.staged_cols * px


def test_smem_budget_marks_the_kernels_staging_limits():
    """K14 stages radius 2 up to spacing 32 (110 KB); the
    bf16 forms stage radius 3 at every spacing (under 200 KB)."""
    k14 = tiling.smem_budget(2, 7, "K14")
    assert k14[5].smem_bytes <= 110 * 1024 < k14[6].smem_bytes
    for kernel in ("K1b bf16", "K14 bf16"):
        assert tiling.smem_budget(3, 8, kernel)[-1].smem_bytes <= 200 * 1024


# the last level (spacing 2^level) at which each adjoint stages its tile
# by default (K14: a block's 227 KB up to spacing 16, 110 KB at 32; K2/K2b:
# 56 KB up to 16, 40 KB at 32), levels 0-7; None: none
@pytest.mark.parametrize("kernel,radius,last", [
    ("K14", 0, None), ("K14", 1, 5), ("K14", 2, 5), ("K14", 3, 4),
    ("K14", 4, 4), ("K14", 5, 4), ("K14", 8, 3),
    ("K2", 0, None), ("K2", 1, 5), ("K2", 2, 4), ("K2", 3, 4),
    ("K2", 4, 3), ("K2", 5, 3), ("K2", 8, 1)])
def test_adjoint_forms_follow_the_staging_budget(kernel, radius, last):
    """K14 and K2/K2b stage within their budgets (the forms atrous.cu's
    header lists), never at radius 0 or past spacing 32; asked to stage,
    they refuse radius 0 and a tile past a block's shared memory."""
    for level in range(8):
        want = last is not None and level <= last
        assert tiling.adjoint_staged(kernel, radius, level) is want
        assert tiling.adjoint_staged(kernel, radius, level, False) is False
        rows, cols = tiling.staged_tile(radius, level)
        nbytes = rows * cols * tiling.STAGED_PIXEL_BYTES[kernel]
        if radius and nbytes <= tiling.SMEM_PER_BLOCK:
            assert tiling.adjoint_staged(kernel, radius, level, True)
        else:
            with pytest.raises(ValueError):
                tiling.adjoint_staged(kernel, radius, level, True)


def test_print_adjoint_forms(capsys):
    tiling.print_adjoint_forms(radii=(3,), levels=6)
    assert capsys.readouterr().out.splitlines() == [
        "K14 r3 levels 0-5: S S S S S C", "K2 r3 levels 0-5: S S S S S C"]


def test_print_model_prints_the_ports_numbers(capsys):
    tiling.print_model(1920, 1080, radius=1, levels=5, kernel="K1b bf16")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and "K1b bf16" in out[0]
    assert "level 4: spacing 16" in out[5]
    assert not any(w in "\n".join(out) for w in ("VMEM", "TPU", "ICI"))


def test_timer_measures_the_block():
    with Timer() as t:
        time.sleep(0.02)
    assert 20.0 <= t.ms < 2000.0
    with Timer() as t2:
        out = t2.sync(torch.ones(4) * 2)
    assert t2.ms >= 0.0 and float(out.sum()) == 8.0


def _wide_form_constants():
    """K12's rolling-row tile's (threads across and down, pixels a thread,
    a chunked segment's taps) and K5/K6's scatter scan's (threads, counts
    a thread), parsed from filters.cu and temporal.cu."""
    src = {p.name: p.read_text() for p in _build.sources()}
    kr = re.search(r"constexpr int KR_TX = (\d+), KR_TY = (\d+), "
                   r"KR_PX = (\d+);", src["filters.cu"])
    seg = re.search(r"constexpr int KR_SEG = (\d+);", src["filters.cu"])
    ks = re.search(r"constexpr int KS_THREADS = (\d+);", src["temporal.cu"])
    items = re.search(r"constexpr int kScanItems = (\d+);",
                      src["temporal.cu"])
    return ((int(kr[1]), int(kr[2]), int(kr[3]), int(seg[1])),
            int(ks[1]) * int(items[1]))


def test_wide_form_constants_are_the_kernels():
    k12, scan = _wide_form_constants()
    assert k12 == (tiling.K12_TX, tiling.K12_TY, tiling.K12_PX,
                   tiling.K12_SEG)
    assert scan == tiling.SCATTER_SCAN_BLOCK


@pytest.mark.parametrize("radius", [5, 8, 16, 17, 24, 40, 90, 164])
def test_k12_ring_fits_a_block(radius):
    """K12's rolling-row tile keeps a ring of 16 rows (the 15 a step reads
    and the next) of ten planes, 32 + 2r columns each, and the 2r + 1
    taps: under the 227 KB a block can have up to r 164 (41.4 KB at r17,
    50.2 KB at r24, 133.2 KB at r90)."""
    nbytes, form = tiling.k12_smem(radius)
    assert form == "ring"
    assert nbytes == 4 * (16 * 10 * (32 + 2 * radius) + 2 * radius + 1)
    assert nbytes <= tiling.SMEM_PER_BLOCK


@pytest.mark.parametrize("radius", [165, 300, 2000])
def test_k12_chunked_form_past_the_ring(radius):
    """Past r 164 a step stages its 8 rows a 256-tap segment at a time:
    the same shared memory at any radius."""
    nbytes, form = tiling.k12_smem(radius)
    assert form == "chunked"
    assert nbytes == 4 * 8 * 10 * (256 + 31) <= tiling.SMEM_PER_BLOCK


@pytest.mark.parametrize("frame,margin,mib", [
    ((1080, 1920), 0, 23.76),            # 1080p
    ((1080, 1920), 61, 26.68),           # 4K quarter canvas, max_motion 60
    ((1080, 1920), 1001, 100.21)])       # 4K quarter canvas, max_motion 1000
def test_scatter_workspace_bytes(frame, margin, mib):
    """K5/K6's scatter workspace: counts and offsets over the (Hc + 1) x
    (Wc + 1) anchor grid and its total, each rounded up to 2048 (a scan
    block), the block sums rounded up to 4, a source index a pixel."""
    H, W = frame
    n = tiling.scatter_workspace_ints(H, W, margin)
    anchors = (H + 2 * margin + 1) * (W + 2 * margin + 1)
    counts = -(-(anchors + 1) // 2048) * 2048
    assert n == 2 * counts + -(-(counts // 2048) // 4) * 4 + H * W
    assert round(4 * n / 2 ** 20, 2) == mib


def test_filter_pass_constants_are_the_kernels():
    """K10's and K11's 1-D passes: outputs a thread and warps a block along
    y, along x (odd: a warp's lanes read its staged row at that stride, 32
    banks), and the shared memory a block of the pass along x stages,
    parsed from filters.cu."""
    src = (_build._SRC_DIR / "filters.cu").read_text()
    ky = re.search(r"constexpr int KY_P = (\d+), KY_WARPS = (\d+);", src)
    kx = re.search(r"constexpr int KX_P = (\d+), KX_WARPS = (\d+);", src)
    smem = re.search(r"constexpr int KX_SMEM = (\d+) \* 1024;", src)
    assert (int(ky[1]), int(ky[2])) == (tiling.PASS_Y_P, tiling.PASS_Y_WARPS)
    assert (int(kx[1]), int(kx[2])) == (tiling.PASS_X_P, tiling.PASS_X_WARPS)
    assert int(smem[1]) * 1024 == tiling.PASS_X_SMEM
    assert tiling.PASS_X_P % 2 == 1
    assert tiling.PASS_X_TW == 32 * tiling.PASS_X_P


# (gauss, radius, width, chunks): whole up to r 1390 (K11, 2781 taps) and
# 1242 (K10) on a frame wide enough; a narrow frame caps the steps at its
# width and a warp's row less one
@pytest.mark.parametrize("gauss,radius,width,chunks", [
    (True, 17, 1920, 1), (True, 90, 1920, 1), (True, 1390, 3840, 1),
    (True, 1391, 3840, 2), (True, 2000, 1920, 1), (True, 5000, 4000, 2),
    (True, 5000, 240, 1), (False, 17, 1920, 1), (False, 1242, 3840, 1),
    (False, 1243, 3840, 2), (False, 2000, 1920, 2), (False, 5000, 240, 1),
    (False, 0, 1920, 1)])
def test_filter_pass_smem_stages_whole_or_in_chunks(gauss, radius, width,
                                                    chunks):
    """The pass along x stages a warp's segment of the steps a chunk takes
    and its row (one segment for the gaussian, two for the box) within the
    block's budget; a chunk is a multiple of the outputs a thread, so the
    register windows rotate alike in every chunk."""
    nbytes, chunk, n = tiling.filter_pass_smem(radius, width, gauss)
    segs = 1 if gauss else 2
    assert n == chunks
    assert chunk % tiling.PASS_X_P == 0
    assert nbytes == 4 * tiling.PASS_X_WARPS * segs * (chunk
                                                      + tiling.PASS_X_TW)
    assert nbytes <= tiling.PASS_X_SMEM
    steps = min(2 * radius + 1 if gauss else radius,
                width + tiling.PASS_X_TW - 1)
    assert chunk * n >= steps and chunk * (n - 1) < max(steps, 1)


def test_filter_pass_radii_are_the_routes():
    """K10 and K11 run as 1-D passes from BOX_PASS_RADIUS and
    GAUSS_PASS_RADIUS up, just past the radii their 2-D bodies are
    compiled at (kBodyRadius of filters.cu, whose 2r + 1 taps fill K11's
    parameter struct; the wrappers read the constants from here)."""
    from raymarchdenoisercuda_torch.ops import filters_cuda
    src = (_build._SRC_DIR / "filters.cu").read_text()
    body = int(re.search(r"constexpr int kBodyRadius = (\d+);", src)[1])
    assert tiling.BOX_PASS_RADIUS == tiling.GAUSS_PASS_RADIUS == body + 1
    assert len(filters_cuda._GaussParams().taps) == 2 * body + 1
    assert filters_cuda.BOX_PASS_RADIUS == tiling.BOX_PASS_RADIUS
    assert filters_cuda.GAUSS_PASS_RADIUS == tiling.GAUSS_PASS_RADIUS
