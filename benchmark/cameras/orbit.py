"""The orbit of ``io/generate.py``'s ``orbit_camera``, frozen: frame f
looks from the point at t = f / ``period``, the constants from the traffic
file; the seed picks the frame the run starts at."""

from __future__ import annotations

import numpy as np


def position(camera: dict, frame: int) -> np.ndarray:
    t = frame / camera["period"]
    r = camera["radius"]
    ang = camera["yaw"] * np.sin(2 * np.pi * t)
    x = r * np.sin(ang) * camera["sway"]
    y = camera["bob"] * np.sin(4 * np.pi * t)
    z = -r + camera["dolly"] * np.cos(2 * np.pi * t) - camera["dolly"]
    return np.asarray([x, y, z], np.float32)


def frames(camera: dict) -> int:
    return int(camera["period"])


def first_frame(camera: dict, word: int) -> int:
    return word % int(camera["period"])
