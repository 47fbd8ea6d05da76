"""Analytical à-trous tiling and memory model of the port's kernels.

Counterpart of ``raymarchdenoisercuda_tpu/utils/tiling.py`` (the
reference's design notebook, ``notebooks/tile.ipynb`` cells 197-205, in
code): dilation spacing, halo radius and tile extent are the same
functions; the memory budgets are the port's own.

* :func:`smem_budget`: the shared memory a block of the level kernels
  stages a level.  K1/K1b (``ops/cuda/atrous_level.cuh``), K14 and the
  bf16 forms lay a row-lattice tile over the frame: at spacing s = 2^level
  a block owns 64 columns by 8 lattice rows of one residue modulo s (image
  rows rho + s·k), whose taps lie on the same lattice, so it stages
  ``8 + 2r`` lattice rows by ``64 + 2r·min(s, 64)`` columns (``Lattice``
  and ``lattice_entries`` in ``ops/cuda/atrous_common.cuh``), times the
  bytes it keeps a pixel (:data:`STAGED_PIXEL_BYTES`).
* :func:`adjoint_staged`: which form the adjoints K14 and K2/K2b
  (``ops/cuda/atrous.cu``) take at a radius and level: staged on the same
  row-lattice tile over the output region while the tile fits the budget
  :data:`ADJOINT_STAGING` gives its spacing, else the centres read through
  the caches, as at radius 0 (``utils/profile.py forms`` measured both
  forms at radius 1-8, levels 0-7).
* :func:`halo_budget`: the bytes a rank receives in the sharded sweep's
  halo exchange (``parallel/halo.py``: rows, then columns of the row-
  extended tile, so the corners come along) for a level's reach r·2^level.
* :func:`k12_smem`: the shared memory of K12's rolling-row tile past r 4
  (``cross_bilateral_rolling_kernel`` in ``ops/cuda/filters.cu``): a ring
  of :data:`K12_RING_ROWS` staged rows of ten planes, 32 + 2r columns
  each, and the 2r + 1 spatial taps; past the 227 KB a block can have,
  the chunked form's 8 rows of a 256-tap segment.
* :func:`filter_pass_smem`: the shared memory a block of K10's and K11's
  pass along x takes (``pass_x_kernel`` in ``ops/cuda/filters.cu``): a
  warp a row, each warp its row's segment of the steps it takes and
  :data:`PASS_X_TW` columns (the box two, the values ahead and behind),
  whole up to :data:`PASS_X_SMEM` a block, past it in chunks of steps;
  and :data:`BOX_PASS_RADIUS` and :data:`GAUSS_PASS_RADIUS`, the radii
  from which ``ops/filters_cuda.py`` runs K10 and K11 as 1-D passes.
* :func:`scatter_workspace_ints`: the workspace of K5/K6's scatter route,
  which ``max_motion`` past 59 takes (``ops/cuda/temporal.cu``): counts and segment
  offsets over the anchor grid (the canvas one row and column wider),
  rounded up to whole scan blocks, the scan's block sums and one source
  index a pixel; the wrapper allocates it (``ops/temporal_cuda.py``).

Numbers here are counts from shapes; none is a measurement.
"""

from __future__ import annotations

import dataclasses
from typing import List

# the level kernels' block tile: columns by lattice rows (K1_TW and K1_TR
# of atrous_level.cuh, K14_TW and K14_TR of atrous.cu)
TILE_COLS = 64
TILE_ROWS = 8
# bytes a block stages a pixel: K1/K1b (colour and variance, luminance,
# normal and depth), K1 with luminance-only weights, K14 (normal and
# depth, u and u2, luminance, sigma, depth gradient), K2/K2b (u and u2, N)
# and the bf16 forms (nine and twelve bf16 planes)
STAGED_PIXEL_BYTES = {"K1": 36, "K1 luma-only": 20, "K14": 48, "K2": 20,
                      "K1b bf16": 18, "K14 bf16": 24}
# the shared memory a block may use on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
# the adjoints' default staging budgets, (spacing up to, largest staged
# tile) in order of spacing; past the last spacing they read through the
# caches.  Measured at 1080p (utils/profile.py forms): K14 (one block of
# 512 threads an SM still wins up to spacing 16) won everywhere it fits
# up to spacing 16, at 32 up to 108 KB and lost at 168 KB, at 64 always
# lost; K2/K2b (its weights stream from device memory: it needs the warps
# of four blocks an SM) won up to 52 KB and lost from 60 KB up to spacing
# 16, at 32 won at 25 KB and lost from 45 KB, at 64 always lost.  A wide
# spacing leaves a lattice residue's last row group part empty while each
# block stages its whole halo.
ADJOINT_STAGING = {"K14": ((16, SMEM_PER_BLOCK), (32, 110 * 1024)),
                   "K2": ((16, 56 * 1024), (32, 40 * 1024))}
# K12's rolling-row tile (KR_TX, KR_TY, KR_PX and KR_SEG of filters.cu):
# threads a block across and down, pixels a thread one above the other,
# and the taps' columns a segment of the chunked form stages
K12_TX, K12_TY, K12_PX, K12_SEG = 32, 8, 2, 256
# the ring: the rows a step reads (KR_TY KR_PX - KR_PX + 1) and the next
K12_RING_ROWS = K12_TY * K12_PX - K12_PX + 2
# K10's and K11's 1-D passes (KY_P, KY_WARPS, KX_P, KX_WARPS and KX_SMEM of
# filters.cu): outputs a thread down a column and warps a block along y;
# outputs a thread along a row (odd: the lanes read the staged row at that
# stride, one bank each), warps a block (a row each) and the shared
# memory a block stages at most along x
PASS_Y_P, PASS_Y_WARPS = 8, 8
PASS_X_P, PASS_X_WARPS = 9, 4
PASS_X_TW = 32 * PASS_X_P
PASS_X_SMEM = 48 * 1024
# the smallest radius K10 and K11 run as 1-D passes: the 2-D bodies are
# compiled at r 0-4 (kBodyRadius of filters.cu), the radii where they beat
# the passes (ops/filters_cuda.py gives the measurement)
BOX_PASS_RADIUS = 5
GAUSS_PASS_RADIUS = 5
# K5/K6 past the staged gather's max_motion (59: its 225 KB region), and
# the counts a block of the scatter's scan adds (KS_THREADS x kScanItems of
# temporal.cu)
GATHER_STAGED_MAX_MOTION = 59
SCATTER_SCAN_BLOCK = 256 * 8


def spacing(level: int) -> int:
    """À-trous hole size at ``level`` (SVGF convention: 2^level; the
    notebook's ``space(n) = 2^(n-1)`` with n from 1)."""
    return 1 << level


def halo_radius(radius: int, level: int) -> int:
    """Pixels of halo a level-``level`` pass needs beyond a tile edge."""
    return radius * spacing(level)


def tile_extent(radius: int, level: int, block: int) -> int:
    """Full extent of a block's input window (the notebook's ``tileRad``)."""
    return 2 * halo_radius(radius, level) + block


@dataclasses.dataclass(frozen=True)
class LevelBudget:
    level: int
    spacing: int
    halo: int
    staged_rows: int        # lattice rows a block stages (its 8 and halo)
    staged_cols: int        # columns a block stages (its 64 and halo)
    smem_bytes: int         # shared memory a block stages
    halo_bytes: int         # halo-exchange bytes a rank (sharded sweep)


def staged_tile(radius: int, level: int):
    """(lattice rows, columns) of a level kernel block's staged tile."""
    sp = min(spacing(level), TILE_COLS)
    return TILE_ROWS + 2 * radius, TILE_COLS + 2 * radius * sp


def smem_budget(radius: int, levels: int,
                kernel: str = "K1") -> List[LevelBudget]:
    """Per-level shared memory of one block of ``kernel`` (a key of
    :data:`STAGED_PIXEL_BYTES`)."""
    px = STAGED_PIXEL_BYTES[kernel]
    out = []
    for lvl in range(levels):
        rows, cols = staged_tile(radius, lvl)
        out.append(LevelBudget(
            level=lvl, spacing=spacing(lvl), halo=halo_radius(radius, lvl),
            staged_rows=rows, staged_cols=cols,
            smem_bytes=rows * cols * px, halo_bytes=0))
    return out


def adjoint_staged(kernel: str, radius: int, level: int,
                   staged=None) -> bool:
    """Whether the adjoint ``kernel`` ("K14", or "K2" for K2/K2b) runs its
    staged form at ``radius`` and ``level``.  ``staged`` None: while the
    staged tile fits the budget :data:`ADJOINT_STAGING` gives the level's
    spacing; True: the staged form (ValueError at radius 0 or past
    :data:`SMEM_PER_BLOCK`); False: the centres through the caches."""
    if staged is False:
        return False
    if radius == 0:
        if staged:
            raise ValueError("radius 0 has no staged form")
        return False
    rows, cols = staged_tile(radius, level)
    nbytes = rows * cols * STAGED_PIXEL_BYTES[kernel]
    if staged is None:
        budget = next((b for s, b in ADJOINT_STAGING[kernel]
                       if spacing(level) <= s), 0)
        return nbytes <= budget
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"{kernel} r{radius} l{level}: a staged tile of "
                         f"{nbytes} B is past the {SMEM_PER_BLOCK} B a "
                         f"block can have")
    return True


def halo_budget(tile_h: int, tile_w: int, radius: int, levels: int,
                n_planes: int = 9, dtype_bytes: int = 4) -> List[LevelBudget]:
    """Per-level halo-exchange bytes a rank receives for a (tile_h, tile_w)
    tile: 2h rows of the tile's width, then 2h columns of the row-extended
    height (corners included), ``n_planes`` planes of ``dtype_bytes``."""
    out = []
    for lvl in range(levels):
        h = halo_radius(radius, lvl)
        cells = 2 * h * tile_w + 2 * h * (tile_h + 2 * h)
        out.append(LevelBudget(
            level=lvl, spacing=spacing(lvl), halo=h,
            staged_rows=tile_h + 2 * h, staged_cols=tile_w + 2 * h,
            smem_bytes=0, halo_bytes=n_planes * cells * dtype_bytes))
    return out


def k12_smem(radius: int):
    """``(bytes, form)``: the shared memory a block of K12's rolling-row
    tile takes at ``radius`` (> 4) and its form, ``"ring"`` while the ring
    fits :data:`SMEM_PER_BLOCK`, else ``"chunked"``."""
    ring = 4 * (K12_RING_ROWS * 10 * (K12_TX + 2 * radius) + 2 * radius + 1)
    if ring <= SMEM_PER_BLOCK:
        return ring, "ring"
    return 4 * K12_TY * 10 * (K12_SEG + K12_TX - 1), "chunked"


def filter_pass_smem(radius: int, width: int, gauss: bool):
    """``(bytes, steps a chunk, chunks)`` of K11's (``gauss``) or K10's
    pass along x at ``radius`` on a frame ``width`` wide: a warp steps
    through at most 2r + 1 gaussian taps or r box steps, and no more than
    the frame's width and a warp's row segment less one (taps whose values
    all lie beyond the frame are not taken); a chunk is a multiple of
    :data:`PASS_X_P` steps, all of them while the block's segments (one
    for the gaussian, two for the box, chunk + :data:`PASS_X_TW` floats
    each, a warp) fit :data:`PASS_X_SMEM`: whole up to r 1390 (K11) and
    1242 (K10) on a wide enough frame."""
    steps = min(2 * radius + 1 if gauss else radius, width + PASS_X_TW - 1)
    segs = 1 if gauss else 2
    fits = ((PASS_X_SMEM // (4 * PASS_X_WARPS * segs) - PASS_X_TW)
            // PASS_X_P * PASS_X_P)
    chunk = max(PASS_X_P, min(-(-steps // PASS_X_P) * PASS_X_P, fits))
    return (4 * PASS_X_WARPS * segs * (chunk + PASS_X_TW), chunk,
            max(1, -(-steps // chunk)))


def scatter_workspace_ints(height: int, width: int, margin: int) -> int:
    """The int32 workspace of K5/K6's (K5c/K6c's) scatter route for a tile
    of ``height`` x ``width`` sources and a history canvas of ``margin``
    (0: the whole frame): counts and offsets over the (Hc + 1) x (Wc + 1)
    anchor grid and its total, rounded up to whole scan blocks, the block
    sums (rounded up to four) and one source index a pixel."""
    anchors = (height + 2 * margin + 1) * (width + 2 * margin + 1)
    counts = -(-(anchors + 1) // SCATTER_SCAN_BLOCK) * SCATTER_SCAN_BLOCK
    blocks = counts // SCATTER_SCAN_BLOCK
    return 2 * counts + -(-blocks // 4) * 4 + height * width


def print_model(width: int = 1920, height: int = 1080, radius: int = 2,
                levels: int = 5, kernel: str = "K1") -> None:
    """Human-readable dump (the notebook's printed tables): per level, the
    staged tile and shared memory of a block of ``kernel``, the blocks a
    frame launches and how many fit an SM by shared memory, and the halo
    bytes a rank of a 2x2 mesh receives."""
    th, tw = -(-height // 2), -(-width // 2)
    halo = halo_budget(th, tw, radius, levels)
    print(f"à-trous model: {width}x{height}, r={radius}, {kernel} block "
          f"{TILE_COLS} columns x {TILE_ROWS} lattice rows")
    for b, x in zip(smem_budget(radius, levels, kernel), halo):
        s = b.spacing
        blocks = (-(-width // TILE_COLS)
                  * -(-(-(-height // s)) // TILE_ROWS) * min(s, height))
        print(f"  level {b.level}: spacing {s:2d}, halo {b.halo:3d}, "
              f"staged {b.staged_rows:2d} x {b.staged_cols:3d}, "
              f"{b.smem_bytes / 1024:6.1f} KB a block "
              f"({SMEM_PER_BLOCK // b.smem_bytes} an SM by shared memory), "
              f"{blocks} blocks; halo {x.halo_bytes / 2**20:.2f} MiB a rank "
              f"of 2x2 ({th}x{tw} tiles)")


def print_wide_forms(width: int = 1920, height: int = 1080) -> None:
    """K12's rolling-row tile's shared memory a block at radii 5-165 (its
    ring up to r 164, chunked past it), K10's and K11's pass along x at
    radii 17-2000 on a frame ``width`` wide, and K5/K6's scatter workspace on the
    frame and on the history canvas of a 3840x2160 frame's quarter tile at
    max_motion 60 and 1000."""
    for r in (5, 17, 24, 90, 164, 165):
        nbytes, form = k12_smem(r)
        print(f"K12 r{r}: {form}, {nbytes / 1024:.1f} KB a block")
    for r in (17, 90, 1242, 1243, 2000):
        for name, gauss in (("K10", False), ("K11", True)):
            nbytes, chunk, chunks = filter_pass_smem(r, width, gauss)
            print(f"{name} pass along x r{r} at width {width}: "
                  f"{nbytes / 1024:.1f} KB a block, {chunks} chunk"
                  f"{'s' if chunks > 1 else ''} of {chunk} steps")
    for name, (h, w, m) in (
            (f"{width}x{height}", (height, width, 0)),
            (f"quarter canvas of {2 * width}x{2 * height} at M60",
             (height, width, 61)),
            (f"quarter canvas of {2 * width}x{2 * height} at M1000",
             (height, width, 1001))):
        n = scatter_workspace_ints(h, w, m)
        print(f"K5/K6 scatter workspace {name}: {4 * n / 2**20:.2f} MiB")


def print_adjoint_forms(radii=(1, 2, 3, 4, 5, 8), levels: int = 8) -> None:
    """The form K14 and K2/K2b take at each radius and level by default
    (:func:`adjoint_staged`): S staged, C the centres through the
    caches."""
    for kernel in ("K14", "K2"):
        for r in radii:
            forms = " ".join("S" if adjoint_staged(kernel, r, lvl) else "C"
                             for lvl in range(levels))
            print(f"{kernel} r{r} levels 0-{levels - 1}: {forms}")


if __name__ == "__main__":
    print_model()
    print_wide_forms()
    print_adjoint_forms()
