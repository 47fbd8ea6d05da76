"""Configuration dataclasses for the PyTorch/CUDA port.

Field-for-field mirror of ``raymarchdenoisercuda_tpu/config.py`` (same
names, same defaults, same validation).  They are mirrored rather than
imported because importing anything under ``raymarchdenoisercuda_tpu``
runs that package's ``__init__``, which imports jax and flax; this package
must import neither.  ``tests/test_torch_config.py`` holds the two copies
equal field by field.

The configs are frozen (hashable) so modules can keep them as static
attributes and kernels can read them as launch arguments.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class FilterType(enum.Enum):
    """Filter families (the reference's ``FilterType`` enum)."""

    AVERAGE = "average"
    GAUSSIAN = "gaussian"
    CROSS = "cross"        # cross-bilateral: edge-stopping on guidance planes
    WAVELET = "wavelet"    # edge-aware à-trous B3-spline wavelet (SVGF)


# B3-spline à-trous coefficients: the symmetric 5-tap expansion of the
# reference's {3/8, 1/4, 1/16} half-kernel.
WAVELET_SPLINE_5: Tuple[float, ...] = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Spatial-filter configuration (the reference's ``FilterParams``)."""

    type: FilterType = FilterType.AVERAGE
    depth: int = 1            # number of iterated filter levels (à-trous iterations)
    level: int = 0            # starting à-trous level (dilation 2^level); WAVELET only
    radius: int = 2           # tap radius; (2r+1)^2 footprint at level 0
    sigma_space: float = 2.0  # gaussian spatial sigma (GAUSSIAN/CROSS)
    sigma_color: float = 4.0  # SVGF sigma_l (luminance edge-stopping)
    sigma_albedo: float = 0.5
    sigma_normal: float = 128.0  # SVGF sigma_n exponent
    sigma_depth: float = 1.0     # SVGF sigma_z

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.radius < 0:
            raise ValueError(f"radius must be >= 0, got {self.radius}")
        if self.level < 0:
            raise ValueError(f"level must be >= 0, got {self.level}")


@dataclasses.dataclass(frozen=True)
class SVGFParams:
    """Full SVGF pipeline configuration (spatial + temporal)."""

    iterations: int = 5          # à-trous iterations (spacing 2^i at level i)
    radius: int = 2              # 5-tap B3 kernel => radius 2
    sigma_color: float = 4.0     # sigma_l
    sigma_normal: float = 128.0  # sigma_n
    sigma_depth: float = 1.0     # sigma_z
    temporal_alpha: float = 0.2        # EMA blend for color history
    temporal_moments_alpha: float = 0.2
    history_clamp: bool = True         # clamp history to neighborhood min/max
    variance_boost_frames: int = 4     # spatial variance fallback for short history
    feedback_level: int = 1      # à-trous level whose output feeds next frame's history
    # Reprojection bound in pixels: |motion| > max_motion counts as
    # disocclusion.  None = unbounded reprojection.
    max_motion: Optional[int] = 6
    # Levels >= luma_only_from filter with the luminance weight alone
    # (per-scene option; None = full weights everywhere).
    luma_only_from: Optional[int] = None
    # Half-resolution deep levels: a reference-only experiment that the port
    # does not implement (the kernel path raises on it, as the JAX one does).
    pyramid_from: Optional[int] = None

    def __post_init__(self):
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.pyramid_from is not None and self.pyramid_from < 1:
            raise ValueError("pyramid_from must be >= 1 (level 0 has no "
                             "coarser footprint to move to)")


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Pinhole camera (static shape info only; the pose is a tensor input)."""

    width: int = 512
    height: int = 512
    fov_y: float = 0.6911  # ~39.6 deg vertical (Cornell-ish)


@dataclasses.dataclass(frozen=True)
class RaymarchParams:
    """Sphere-tracing configuration."""

    max_steps: int = 64
    max_dist: float = 20.0
    hit_eps: float = 1e-3
    normal_eps: float = 1e-3
    samples_per_pixel: int = 1   # MC noise level of the "noisy render" plane
    shadow_steps: int = 32
    light_samples: int = 1
    # Over-relaxed sphere tracing (Keinert et al.): step ω·d with an overlap
    # test that rolls a failed step back.  1.0 disables relaxation.
    relax_omega: float = 1.0
    # Cone pre-march seed: one cone a 4x4 pixel block is marched against the
    # distance fattened by the block's ray spread (kernel K15), and each
    # pixel's primary march starts at its block's stop instead of 0.  Off by
    # default; the plain renderer (impl="plain") ignores it.
    coarse_seed: bool = False


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One benchmark configuration (BASELINE.md configs table)."""

    name: str
    width: int
    height: int
    iterations: int = 5
    frames: int = 1
    temporal: bool = False
    backward: bool = False
