"""Serving with the paper's unbounded reprojection (``max_motion`` null):
``frame_pipeline``'s driver, faults and controls, checked against the
unbounded reference (``reference/denoise_unbounded.py``) in place of the
bounded one.  The program is the same ``FramePipeline``; its
``SVGFParams(max_motion=None)`` takes the clamped-gather route."""

from __future__ import annotations

import torch

from ..reference import denoise_unbounded
from . import frame_pipeline, patched
from .frame_pipeline import FAULTS, PROGRAM_CONTROLS, control_numbers

__all__ = ["Driver", "FAULTS", "PROGRAM_CONTROLS", "control_numbers"]


class Driver(frame_pipeline.Driver):

    def reference_frame(self, rec: dict, dtype=torch.float32):
        """``frame_pipeline.Driver.reference_frame`` with the unbounded
        reference's ``denoise`` and ``zero_history``."""
        with patched(frame_pipeline, "ref_denoise", denoise_unbounded):
            return super().reference_frame(rec, dtype)
