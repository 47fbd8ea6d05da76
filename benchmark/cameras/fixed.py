"""A camera that stays at ``position``."""

from __future__ import annotations

import numpy as np


def position(camera: dict, frame: int) -> np.ndarray:
    return np.asarray(camera["position"], np.float32)


def frames(camera: dict) -> int:
    return 1


def first_frame(camera: dict, word: int) -> int:
    return 0
