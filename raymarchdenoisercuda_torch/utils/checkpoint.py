"""Checkpoint and resume of the temporal history and the training state.

Counterpart of ``raymarchdenoisercuda_tpu/utils/checkpoint.py``'s
:func:`save` and :func:`restore`: one ``.npz`` archive of numpy arrays,
each leaf under its ``/``-joined path, shapes checked on restore.  The
layout is the JAX package's, so either package reads the other's files:
a ``TrainState`` is written as ``albedo``, ``opt_state/0/count``,
``opt_state/0/mu``, ``opt_state/0/nu`` (optax's Adam state; Adam's
``step``, ``exp_avg`` and ``exp_avg_sq`` here) and ``history/<field>``,
and a ``History`` or ``GBuffer`` as its fields (``None`` fields are left
out).  The JAX package's PRNG ``key`` does not carry over to torch's
generator: restoring its file keeps the generator of ``like``; this
package writes its generator's state under ``generator``.  The JAX
package's orbax variants write the same layout when orbax is absent;
this package has no orbax.  numpy only: no pickles.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from ..convert import train_state_from_numpy, train_state_to_numpy
from ..models.pipeline import TrainState


def _tree(obj: Any) -> Any:
    """Nested dicts and lists of numpy arrays in the JAX package's layout;
    ``None`` where the JAX package's pytree has no leaf."""
    if isinstance(obj, TrainState):
        d = train_state_to_numpy(obj)
        tree = {"albedo": d["albedo"], "opt_state": [d["adam"]],
                "history": d["history"]}
        if obj.generator is not None:
            tree["generator"] = obj.generator.get_state().numpy()
        return tree
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray) or np.isscalar(obj):
        return np.asarray(obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: _tree(v) for k, v in zip(obj._fields, obj)}
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    if obj is None:
        return None
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else None)
    if items is None:
        return {} if tree is None else {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save(path: str, obj: Any) -> None:
    """Write ``obj`` (a ``TrainState``, ``History``, ``GBuffer``, tensor, or
    dicts, lists and NamedTuples of them) to ``path`` as a ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(_tree(obj)))


def _read(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        return dict(data.items())


def _leaf(flat, key, like, path):
    if key not in flat:
        raise KeyError(f"checkpoint {path} has no leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"leaf {key!r}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(np.shape(like))}")
    return arr


def _rebuild(flat, prefix, like, path):
    """``like``'s structure with each leaf read from ``flat``."""
    if isinstance(like, torch.Tensor):
        arr = _leaf(flat, prefix, like, path)
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray) or np.isscalar(like):
        return np.asarray(_leaf(flat, prefix, like, path))
    if like is None:
        return None

    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(flat, key(f.name), getattr(like, f.name), path)
            for f in dataclasses.fields(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(flat, key(k), v, path)
                            for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _rebuild(flat, key(k), v, path) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(flat, key(i), v, path)
                          for i, v in enumerate(like))
    raise TypeError(f"cannot restore a {type(like).__name__}")


def _restore_train_state(flat, like: TrainState, path) -> TrainState:
    want = _flatten(_tree(like))
    for k in ("albedo", "opt_state/0/count", "opt_state/0/mu",
              "opt_state/0/nu") + tuple(k for k in want
                                        if k.startswith("history/")):
        _leaf(flat, k, want[k], path)
    adam = {k: flat[f"opt_state/0/{k}"] for k in ("count", "mu", "nu")}
    history = {k[len("history/"):]: v for k, v in flat.items()
               if k.startswith("history/")}
    gen = like.generator
    if gen is not None and "generator" in flat:
        gen = torch.Generator(gen.device)
        gen.set_state(torch.from_numpy(flat["generator"]))
    return train_state_from_numpy(
        flat["albedo"], adam, history, like.albedo.device, gen,
        lr=like.optimizer.param_groups[0]["lr"])


def restore(path: str, like: Any) -> Any:
    """Read a checkpoint written by :func:`save` (or by the JAX package's
    ``save``) into an object of ``like``'s structure, on its devices and
    dtypes; a missing leaf raises ``KeyError``, a leaf of another shape
    ``ValueError``."""
    flat = _read(path)
    if isinstance(like, TrainState):
        return _restore_train_state(flat, like, path)
    return _rebuild(flat, "", like, path)
