"""What a cell's window drives, and how its outputs are checked.

A configuration's ``entry`` names the driver: the module
``drivers/<entry>.py``, found by that name, so a new entry point is a new
module and no file here changes.  A driver module has

* ``Driver(config, traffic, seed, device)``: builds the program from the
  configuration and the traffic; ``unit`` ("frame", "step"); ``setup()``
  runs the traffic's warm-up (the same chain or state the window then
  continues); ``dispatch(n)`` one unit; ``release()`` drops the program's
  state once the window has closed; ``check()`` returns the numbers of
  :mod:`benchmark.check`; ``notes``, lines that a run prints;
* ``FAULTS``: ``{name: context manager}``, each planting one fault the
  cell can have under the timed path (``calibrate.py``, the tests);
* ``control_numbers(driver)``: the numbers with the reference in bfloat16
  in the program's place, once ``check`` has run;
* ``PROGRAM_CONTROLS``: ``{name: configuration changes}`` that switch on
  a lower-precision path of the program's own.

The reference (:mod:`benchmark.reference`) gets the same scene, cameras,
target and initial table, redraws the light points from the generator
state the program drew them from, and works everything else out itself.
"""

from __future__ import annotations

import contextlib
import importlib
import re

import torch

from .. import traffic as traffic_gen

GBUF_PLANES = ("render", "albedo", "normal", "depth", "motion")
HIST_PLANES = ("color", "moments", "length")
ENTRY_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(entry: str):
    """The driver module of ``entry``."""
    if not ENTRY_NAME.match(entry):
        raise ValueError(f"entry {entry!r} is not a module name")
    return importlib.import_module(f"{__name__}.{entry}")


def make(config: dict, traffic: dict, seed: int, device):
    return load(config["entry"]).Driver(config, traffic, seed, device)


def tensor(a, device, dtype=None):
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def reference_scene(arrays: dict, device, dtype=torch.float32) -> dict:
    return {k: tensor(v, device, dtype if v.dtype.kind == "f" else None)
            for k, v in arrays.items()}


def reference_camera(traffic: dict, frame: int, device,
                     dtype=torch.float32) -> dict:
    cam = traffic["camera"]
    return dict(position=tensor(traffic_gen.camera_position(cam, frame),
                                device, dtype),
                look_at=tensor(cam["look_at"], device, dtype),
                up=tensor(cam["up"], device, dtype))


def host(planes: dict, names) -> dict:
    return {k: planes[k].detach().to("cpu") for k in names}


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` is ``value`` for the duration."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Program:
    """What every driver builds from the program: its scene, cameras and
    configuration objects, and the generator of the light points."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from raymarchdenoisercuda_torch.config import (CameraParams,
                                                       RaymarchParams,
                                                       SVGFParams)
        from raymarchdenoisercuda_torch.ops.raymarch import (Camera,
                                                             Materials,
                                                             Scene)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.notes = []
        self.H, self.W = int(config["height"]), int(config["width"])
        self.cam_cfg = CameraParams(width=self.W, height=self.H,
                                    fov_y=float(config["fov_y"]))
        self.rm = RaymarchParams(**config["raymarch"])
        self.svgf = SVGFParams(**config["svgf"])
        self.arrays = traffic_gen.scene_arrays(traffic)
        a, dev = self.arrays, self.device

        def f(k):
            return tensor(a[k], dev, torch.float32)

        def i(k):
            return tensor(a[k], dev, torch.int32)

        self.scene = Scene(
            sphere_params=f("spheres"), sphere_mat=i("sphere_mat"),
            box_params=f("boxes"), box_mat=i("box_mat"),
            plane_params=f("planes"), plane_mat=i("plane_mat"),
            materials=Materials(albedo=f("albedo"), emission=f("emission")),
            light_center=f("light_center"), light_u=f("light_u"),
            light_v=f("light_v"), light_radiance=f("light_radiance"))
        cam = traffic["camera"]
        self.cameras = [Camera(
            position=tensor(traffic_gen.camera_position(cam, k), dev),
            look_at=tensor(cam["look_at"], dev, torch.float32),
            up=tensor(cam["up"], dev, torch.float32))
            for k in range(traffic_gen.distinct_frames(traffic))]
        self.gen = traffic_gen.light_generator(seed, torch, dev)

    def camera(self, frame: int):
        return self.cameras[frame % len(self.cameras)]

    def ref_cfg(self) -> dict:
        return dict(width=self.W, height=self.H,
                    fov_y=float(self.config["fov_y"]))

    def ref_generator(self, state):
        g = torch.Generator(self.device)
        g.set_state(state)
        return g

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
