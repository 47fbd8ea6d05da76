"""The one generator that every traffic file feeds: a traffic mix is a JSON
file of parameters under ``traffic/``, and this module turns it and
``--seed`` into a run's inputs.

A traffic file holds:

* ``scene``: the scene's arrays (``spheres``, ``boxes``, ``planes`` and
  their material ids, the material ``albedo`` and ``emission`` tables, and
  the light), frozen in the file;
* ``camera``: ``{"path": <name>, ...}``, the path's parameters and
  ``look_at`` and ``up``; the path is the module ``cameras/<name>.py``
  (``orbit``: the orbit of ``io/generate.py``, its constants in the file;
  ``fixed``: one ``position``);
* ``in_flight``: units (frames or steps) outstanding in the closed loop;
* ``warmup``: units run in set-up before the window;
* for training: ``lr`` (Adam), ``albedo_perturbation`` (the initial table
  is the scene's plus a uniform draw of that half-width, clamped to
  [0, 1]) and ``target``, the module ``targets/<name>.py`` that makes the
  image the step fits.

So a new mix of existing kinds is a data file, and a new kind of camera
path or target a new module beside the others: no file here changes.

What the seed decides: the light points (a ``torch.Generator`` on the
device, drawn by the program itself one frame at a time), the orbit's
starting frame, the initial table and the target's own light draw.  Every
seed gives the same sizes and the same kind of work.
"""

from __future__ import annotations

import importlib
import re

import numpy as np

SCENE_FLOATS = ("spheres", "boxes", "planes", "albedo", "emission",
                "light_center", "light_u", "light_v", "light_radiance")
SCENE_IDS = ("sphere_mat", "box_mat", "plane_mat")
PART_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def part(kind: str, name: str):
    """The module ``<kind>/<name>.py`` beside this one (``cameras``,
    ``targets``)."""
    if not PART_NAME.match(name):
        raise ValueError(f"{kind} {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def seeds(seed: int):
    """Four independent 62-bit seeds from ``--seed`` (any whole number):
    the light points, the data (initial table), the orbit phase, the
    target's light draw."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(
        8, np.uint32).astype(np.uint64)
    return [int((words[2 * i] << np.uint64(30)) ^ words[2 * i + 1])
            for i in range(4)]


def scene_arrays(traffic: dict) -> dict:
    """The scene as float32 / int64 numpy arrays."""
    s = traffic["scene"]
    out = {k: np.asarray(s[k], np.float32) for k in SCENE_FLOATS}
    out.update({k: np.asarray(s[k], np.int64) for k in SCENE_IDS})
    return out


def camera_position(camera: dict, frame: int) -> np.ndarray:
    """Where frame ``frame`` looks from, rounded to float32."""
    return part("cameras", camera["path"]).position(camera, frame)


def first_frame(traffic: dict, seed: int) -> int:
    """The frame of the camera path the run starts at."""
    cam = traffic["camera"]
    return part("cameras", cam["path"]).first_frame(cam, seeds(seed)[2])


def distinct_frames(traffic: dict) -> int:
    """How many frames the camera path has before it repeats."""
    cam = traffic["camera"]
    return part("cameras", cam["path"]).frames(cam)


def initial_albedo(traffic: dict, seed: int) -> np.ndarray:
    """The table training starts from: the scene's, plus a uniform draw in
    ±``albedo_perturbation`` from the seed, clamped to [0, 1]."""
    base = scene_arrays(traffic)["albedo"]
    rng = np.random.default_rng(seeds(seed)[1])
    h = traffic["albedo_perturbation"]
    return np.clip(base + rng.uniform(-h, h, base.shape), 0.0,
                   1.0).astype(np.float32)


def target_image(program):
    """The image training fits, made by ``targets/<target>.py`` for the
    driver ``program`` (its scene, camera, configuration and seed)."""
    return part("targets", program.traffic["target"]).make(program)


def light_generator(seed: int, torch, device, stream: int = 0):
    """A generator seeded from ``--seed``: stream 0 is the one the program
    draws its light points from, 3 the target's."""
    return torch.Generator(device).manual_seed(seeds(seed)[stream])
