"""State carry-over between the JAX package and this port.

Every function here takes or returns plain ``dict``s of numpy arrays, so
the port never imports jax: a caller turns a JAX object into such a dict
with :func:`fields_to_numpy` (which only reads dataclass fields, and flax
structs are dataclasses) and hands it over.  ``*_from_numpy`` build the
port's objects on a given device; ``*_to_numpy`` go back, for plane-by-plane
comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .gbuffer import GBuffer, History
from .models.pipeline import TrainState, init_train_state
from .ops.raymarch import Camera, Materials, Scene


def fields_to_numpy(obj: Any) -> Dict[str, Any]:
    """Dict of numpy arrays from a dataclass's fields, nested dataclasses
    as nested dicts and ``None`` fields kept as ``None``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = fields_to_numpy(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def _t(x, device, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _opt(x, device):
    return None if x is None else _t(x, device)


def scene_from_numpy(d: Mapping[str, Any], device) -> Scene:
    """Port ``Scene`` from the reference ``Scene``'s fields; ``materials``
    may be a nested dict or flat ``albedo``/``emission`` keys."""
    mats = d["materials"] if "materials" in d else d
    return Scene(
        sphere_params=_t(d["sphere_params"], device),
        sphere_mat=_t(d["sphere_mat"], device, torch.int32),
        box_params=_t(d["box_params"], device),
        box_mat=_t(d["box_mat"], device, torch.int32),
        plane_params=_t(d["plane_params"], device),
        plane_mat=_t(d["plane_mat"], device, torch.int32),
        materials=Materials(albedo=_t(mats["albedo"], device),
                            emission=_t(mats["emission"], device)),
        light_center=_t(d["light_center"], device),
        light_u=_t(d["light_u"], device),
        light_v=_t(d["light_v"], device),
        light_radiance=_t(d["light_radiance"], device),
    )


def camera_from_numpy(d: Mapping[str, Any], device) -> Camera:
    return Camera(position=_t(d["position"], device),
                  look_at=_t(d["look_at"], device), up=_t(d["up"], device))


def gbuffer_from_numpy(d: Mapping[str, Any], device) -> GBuffer:
    return GBuffer(render=_t(d["render"], device),
                   albedo=_t(d["albedo"], device),
                   normal=_t(d["normal"], device),
                   depth=_t(d["depth"], device),
                   motion=_opt(d.get("motion"), device),
                   denoised=_opt(d.get("denoised"), device))


def history_from_numpy(d: Mapping[str, Any], device) -> History:
    return History(color=_t(d["color"], device),
                   moments=_t(d["moments"], device),
                   length=_t(d["length"], device),
                   prev_depth=_t(d["prev_depth"], device),
                   prev_normal=_t(d["prev_normal"], device))


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def gbuffer_to_numpy(g: GBuffer) -> Dict[str, Any]:
    return {f.name: _np(getattr(g, f.name)) for f in dataclasses.fields(g)}


def history_to_numpy(h: History) -> Dict[str, Any]:
    return {f.name: _np(getattr(h, f.name)) for f in dataclasses.fields(h)}


def train_state_from_numpy(albedo, adam: Mapping[str, Any],
                           history: Mapping[str, Any], device,
                           generator=None, *, lr: float = 1e-2) -> TrainState:
    """Port ``TrainState`` from the JAX package's: the albedo table, optax's
    ``ScaleByAdamState`` fields ``count``, ``mu``, ``nu`` (which become
    Adam's ``step``, ``exp_avg``, ``exp_avg_sq``) and the history's
    fields.  The PRNG key does not carry over: pass ``generator``, or the
    light samples, to the train step."""
    h = history_from_numpy(history, device)
    state = init_train_state(_t(albedo, device), *h.length.shape, generator,
                             lr=lr)
    state.optimizer.state[state.albedo] = {
        # Adam keeps a non-capturable step count as a float32 CPU scalar
        "step": torch.tensor(float(np.asarray(adam["count"])),
                             dtype=torch.float32),
        "exp_avg": _t(adam["mu"], device),
        "exp_avg_sq": _t(adam["nu"], device),
    }
    return state._replace(history=h)


def train_state_to_numpy(state: TrainState) -> Dict[str, Any]:
    """Back to numpy: ``albedo``, ``adam`` (``count``, ``mu``, ``nu`` as
    optax names them; zeros before the first step) and ``history``."""
    st = state.optimizer.state.get(state.albedo, {})
    zeros = np.zeros(tuple(state.albedo.shape), np.float32)
    adam = {"count": np.asarray(int(st["step"]) if "step" in st else 0,
                                np.int32),
            "mu": _np(st["exp_avg"]) if "exp_avg" in st else zeros,
            "nu": _np(st["exp_avg_sq"]) if "exp_avg_sq" in st else zeros}
    return {"albedo": _np(state.albedo), "adam": adam,
            "history": history_to_numpy(state.history)}
