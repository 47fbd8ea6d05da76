"""Checkpoints of the port (``utils/checkpoint.py``) against the JAX
package's ``.npz`` layout: a ``TrainState`` with its Adam state and a
``History`` survive a round trip bit for bit, a file written by the JAX
package's ``save`` restores into the port's objects, a ``History`` the
port writes restores in the JAX package, and a leaf of another shape or a
missing one raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raymarchdenoisercuda_tpu.gbuffer import History as JHistory
from raymarchdenoisercuda_tpu.models.pipeline import (
    init_train_state as j_init_train_state)
from raymarchdenoisercuda_tpu.utils import checkpoint as jckpt
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.pipeline import init_train_state
from raymarchdenoisercuda_torch.utils import checkpoint

H, W, M = 4, 6, 5


def _history(seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    return History(color=t(3, H, W), moments=t(2, H, W), length=t(H, W),
                   prev_depth=t(H, W), prev_normal=t(3, H, W))


def _stepped_state(seed):
    """A port ``TrainState`` after two Adam steps on seeded gradients."""
    rng = np.random.default_rng(seed)
    albedo = torch.from_numpy(rng.random((M, 3), dtype=np.float32))
    state = init_train_state(albedo, H, W, torch.Generator().manual_seed(3))
    for _ in range(2):
        state.albedo.grad = torch.from_numpy(
            rng.standard_normal((M, 3)).astype(np.float32))
        state.optimizer.step()
    return state._replace(history=_history(seed + 1))


def _assert_states_equal(a, b):
    assert torch.equal(a.albedo, b.albedo)
    sa = a.optimizer.state[a.albedo]
    sb = b.optimizer.state[b.albedo]
    assert float(sa["step"]) == float(sb["step"])
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(sa[k], sb[k]), k
    for f in dataclasses.fields(History):
        assert torch.equal(getattr(a.history, f.name),
                           getattr(b.history, f.name)), f.name


def test_train_state_and_history_round_trip(tmp_path):
    state = _stepped_state(0)
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, state)
    keys = set(np.load(path).files)
    assert {"albedo", "opt_state/0/count", "opt_state/0/mu",
            "opt_state/0/nu", "history/color", "generator"} <= keys
    like = init_train_state(torch.zeros((M, 3)), H, W,
                            torch.Generator().manual_seed(9))
    got = checkpoint.restore(path, like)
    _assert_states_equal(got, state)
    # the generator's state came back too: the next draws are the same
    assert torch.equal(torch.rand(4, generator=got.generator),
                       torch.rand(4, generator=state.generator))
    # the restored state steps on as the original does
    for s in (state, got):
        s.albedo.grad = torch.full((M, 3), 0.25)
        s.optimizer.step()
    _assert_states_equal(got, state)

    hist = _history(5)
    checkpoint.save(str(tmp_path / "hist"), hist)
    back = checkpoint.restore(str(tmp_path / "hist"),
                              History.zeros(H, W, device="cpu"))
    for f in dataclasses.fields(History):
        assert torch.equal(getattr(back, f.name), getattr(hist, f.name))
    g = GBuffer(render=hist.color, albedo=hist.color, normal=hist.prev_normal,
                depth=hist.length, motion=hist.moments, denoised=None)
    checkpoint.save(str(tmp_path / "gbuf.npz"), g)
    back = checkpoint.restore(str(tmp_path / "gbuf.npz"), g)
    assert back.denoised is None and torch.equal(back.motion, g.motion)


def test_jax_written_checkpoint_restores(tmp_path):
    """A JAX ``TrainState`` (optax Adam state with a step count, a history)
    saved by the JAX package's ``save`` restores into the port's objects
    through ``convert.train_state_from_numpy``; a ``History`` written by
    the port restores in the JAX package."""
    rng = np.random.default_rng(7)
    albedo = jnp.asarray(rng.random((M, 3), dtype=np.float32))
    js = j_init_train_state(albedo, optax.adam(1e-2), H, W,
                            jax.random.PRNGKey(0))
    adam = js.opt_state[0]._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jnp.asarray(rng.standard_normal((M, 3)), jnp.float32),
        nu=jnp.asarray(rng.random((M, 3)), jnp.float32))
    jh = JHistory(**{f.name: jnp.asarray(
        rng.random(np.shape(getattr(js.history, f.name)), np.float32))
        for f in dataclasses.fields(JHistory)})
    js = js._replace(opt_state=(adam,) + tuple(js.opt_state[1:]),
                     history=jh)
    path = str(tmp_path / "jax_state.npz")
    jckpt.save(path, js)
    like = init_train_state(torch.zeros((M, 3)), H, W)
    got = checkpoint.restore(path, like)
    np.testing.assert_array_equal(got.albedo.detach().numpy(),
                                  np.asarray(albedo))
    st = got.optimizer.state[got.albedo]
    assert float(st["step"]) == 3.0
    np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(adam.mu))
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                  np.asarray(adam.nu))
    for f in dataclasses.fields(History):
        np.testing.assert_array_equal(getattr(got.history, f.name).numpy(),
                                      np.asarray(getattr(jh, f.name)))

    hist = _history(11)
    checkpoint.save(str(tmp_path / "port_hist.npz"), hist)
    back = jckpt.restore(str(tmp_path / "port_hist.npz"),
                         JHistory.zeros(H, W))
    for f in dataclasses.fields(History):
        np.testing.assert_array_equal(np.asarray(getattr(back, f.name)),
                                      getattr(hist, f.name).numpy())


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, _stepped_state(1))
    with pytest.raises(ValueError, match="history/color"):
        checkpoint.restore(path, init_train_state(torch.zeros((M, 3)), H + 1,
                                                  W))
    with pytest.raises(ValueError, match="albedo"):
        checkpoint.restore(path, init_train_state(torch.zeros((M + 1, 3)),
                                                  H, W))
    checkpoint.save(path, {"color": torch.zeros(3, H, W)})
    with pytest.raises(KeyError, match="moments"):
        checkpoint.restore(path, History.zeros(H, W, device="cpu"))
