"""G-buffer and temporal-history data model: planar float32 tensors.

Counterpart of ``raymarchdenoisercuda_tpu/gbuffer.py``.  Every colour-like
plane is ``(C, H, W)``, every scalar plane ``(H, W)``; all tensors of one
object live on one device.  The dataclasses are frozen: functions return new
objects (``dataclasses.replace``) instead of mutating planes in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Per-frame geometry buffers.

    ``render`` is the noisy 1-spp colour; ``albedo``/``normal``/``depth`` are
    the guidance planes; ``motion`` holds (dy, dx) screen-space motion in
    pixels pointing into the previous frame; ``denoised`` is the filter
    output.
    """

    render: torch.Tensor                     # (3, H, W)
    albedo: torch.Tensor                     # (3, H, W)
    normal: torch.Tensor                     # (3, H, W), unit vectors in [-1, 1]
    depth: torch.Tensor                      # (H, W)
    motion: Optional[torch.Tensor] = None    # (2, H, W) pixels (dy, dx)
    denoised: Optional[torch.Tensor] = None  # (3, H, W)

    @property
    def shape(self):
        """(H, W)."""
        return tuple(self.render.shape[-2:])

    @property
    def height(self) -> int:
        return self.render.shape[-2]

    @property
    def width(self) -> int:
        return self.render.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.render.device

    def replace(self, **changes) -> "GBuffer":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class History:
    """Temporal accumulation state carried from frame to frame (SVGF)."""

    color: torch.Tensor        # (3, H, W) accumulated colour
    moments: torch.Tensor      # (2, H, W) accumulated (E[l], E[l^2])
    length: torch.Tensor       # (H, W) history length (frames, float)
    prev_depth: torch.Tensor   # (H, W)
    prev_normal: torch.Tensor  # (3, H, W)

    @classmethod
    def zeros(cls, height: int, width: int, *, device,
              dtype=torch.float32) -> "History":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(color=z(3, height, width), moments=z(2, height, width),
                   length=z(height, width), prev_depth=z(height, width),
                   prev_normal=z(3, height, width))

    def replace(self, **changes) -> "History":
        return dataclasses.replace(self, **changes)


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of a planar (3, H, W) colour plane -> (H, W)."""
    return 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]


def zeros_gbuffer(height: int, width: int, *, device,
                  dtype=torch.float32) -> GBuffer:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GBuffer(render=z(3, height, width), albedo=z(3, height, width),
                   normal=z(3, height, width), depth=z(height, width),
                   motion=z(2, height, width), denoised=z(3, height, width))
