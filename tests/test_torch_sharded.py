"""The port's sharded sweep and temporal step (``parallel/sharded.py``) on
gloo process groups, against the JAX package's single-device oracles,
mirroring ``tests/test_sharded.py``.

One group a mesh shape ((1, 2, 2); (1, 2, 4), where the 5-level sweep's
32-pixel halo exceeds the 16-pixel tiles and takes the multi-hop per-level
kernel path; (2, 1, 2), a data axis) runs every check
(``tests/_torch_sharded_workers.py``):

* the sweep, ``impl="plain"`` (the oracle path on exchanged tiles) and
  ``impl="auto"`` (the plain twins of the kernels' tile forms K1, K1b with
  the tile's origin and the frame's bounds) in each adjoint mode's forward,
  against ``svgf_spatial_ref(detach_weights=True)`` at rtol 5e-5, atol
  1e-5 (variance atol 1e-6), ``tests/test_sharded.py:56-59``; the 500x500
  shape, a non-divisible 61x93 one (pad and mask), deep levels and the
  luma-only headline mode (its stored path, atol 1e-4/1e-5 as there);
* the temporal step over two frames whose motion crosses tiles (up to
  max_motion), with a History carry (``plain``, ``fused``: K3 with an
  origin, ``ad``: K4 on the exchanged tile) and a canvas carry
  (``fused_canvas``: K3b, ``ad_canvas``: K4c), against two steps of JAX's
  ``temporal_accumulate`` at rtol 1e-5, atol 1e-5 (variance atol 1e-6),
  the history length exactly (``tests/test_sharded.py:419``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchdenoisercuda_tpu.config import SVGFParams as JSVGFParams
from raymarchdenoisercuda_tpu.gbuffer import (GBuffer as JGBuffer,
                                              History as JHistory)
from raymarchdenoisercuda_tpu.ops.atrous import svgf_spatial_ref
from raymarchdenoisercuda_tpu.ops.temporal import temporal_accumulate
from raymarchdenoisercuda_torch.config import (
    CameraParams, RaymarchParams, SVGFParams)
from raymarchdenoisercuda_torch.gbuffer import History
from raymarchdenoisercuda_torch.parallel import sharded
from raymarchdenoisercuda_torch.parallel.mesh import make_mesh

from _torch_sharded_workers import run_group

MESHES = [(1, 2, 2), (1, 2, 4), (2, 1, 2)]
SWEEPS = {
    # name: (shape, SVGFParams kwargs, impl, bwd_impl)
    "plain": ((64, 64), dict(iterations=3), "plain", "auto"),
    "recompute": ((64, 64), dict(iterations=3), "auto", "recompute"),
    "stored": ((64, 64), dict(iterations=3), "auto", "stored"),
    "none": ((64, 64), dict(iterations=3), "auto", "none"),
    "deep": ((64, 64), dict(iterations=5), "auto", "auto"),
    "luma": ((64, 64), dict(iterations=5, radius=1, luma_only_from=3),
             "auto", "stored"),
    "luma_plain": ((64, 64), dict(iterations=5, radius=1, luma_only_from=3),
                   "plain", "auto"),
    "p500": ((500, 500), dict(iterations=3), "plain", "auto"),
    "k500": ((500, 500), dict(iterations=3), "auto", "recompute"),
    "pad": ((61, 93), dict(iterations=2), "auto", "recompute"),
    "pad_plain": ((61, 93), dict(iterations=2), "plain", "auto"),
}
TEMPORALS = ("plain", "fused", "ad", "fused_canvas", "ad_canvas")
TH = TW = 48


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    color = rng.random((3, H, W), dtype=np.float32)
    variance = (0.02 * rng.random((H, W))).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    return color, variance, n, depth


def _frames():
    """Two frames of the JAX test: motion up to ±3.5 and ±3.9 pixels
    (max_motion 4), the second sharing the first's geometry."""
    c1, _, n, d = _planes(1, TH, TW)
    c2 = _planes(2, TH, TW)[0]
    frames = []
    for seed, mag, c in ((1, 3.5, c1), (2, 3.9, c2)):
        motion = ((2.0 * np.random.default_rng(seed).random((2, TH, TW))
                   - 1.0) * mag).astype(np.float32)
        frames.append(dict(render=c, albedo=c, normal=n, depth=d,
                           motion=motion))
    return frames


@pytest.fixture(scope="module")
def jax_refs():
    sweeps = {}
    for k, (shape, kw, _impl, _bwd) in SWEEPS.items():
        planes = _planes(sum(shape), *shape)
        out = svgf_spatial_ref(*(jnp.asarray(p) for p in planes),
                               params=JSVGFParams(**kw), detach_weights=True,
                               return_feedback=True)
        sweeps[k] = (planes, [np.asarray(o) for o in out])
    params = JSVGFParams(max_motion=4)
    h = JHistory.zeros(TH, TW)
    temporal = []
    for f in _frames():
        integ, var, h = temporal_accumulate(
            JGBuffer(**{k: jnp.asarray(v) for k, v in f.items()}), h,
            params=params)
        temporal.append((np.asarray(integ), np.asarray(var)))
    return sweeps, temporal, np.asarray(h.length)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_sweep_and_temporal_match_jax(tmp_path, mesh_shape,
                                              jax_refs):
    sweeps, temporal, length = jax_refs
    cases = {k: (sweeps[k][0], SVGFParams(**kw), impl, bwd)
             for k, (_s, kw, impl, bwd) in SWEEPS.items()}
    jobs = dict(
        sweep=("sweep_worker", dict(cases=cases)),
        temporal=("temporal_worker", dict(
            frames=_frames(), params=SVGFParams(max_motion=4),
            impls=TEMPORALS)))
    res = run_group(tmp_path, mesh_shape, "multi_worker", jobs=jobs)[0]
    for k, (_s, kw, _impl, bwd) in SWEEPS.items():
        stored = bwd == "stored"
        for name, want, tol in zip(
                ("color", "variance", "feedback"), sweeps[k][1],
                ((1e-4 if stored else 1e-5), (1e-5 if stored else 1e-6),
                 (1e-4 if stored else 1e-5))):
            np.testing.assert_allclose(res[f"sweep/{k}_{name}"], want,
                                       rtol=5e-5, atol=tol,
                                       err_msg=f"{k} {name}")
    for impl in TEMPORALS:
        for f, (integ, var) in enumerate(temporal):
            np.testing.assert_allclose(res[f"temporal/{impl}_integrated{f}"],
                                       integ, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{impl} frame {f}")
            np.testing.assert_allclose(res[f"temporal/{impl}_variance{f}"],
                                       var, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{impl} frame {f}")
        np.testing.assert_array_equal(res[f"temporal/{impl}_length"],
                                      length)


def test_sharded_luma_mode_guards():
    """luma_only_from raises where the kernels cannot run it: the per-level
    multi-hop path (the halo exceeds the tile) and the chained recompute
    adjoint (``tests/test_sharded.py:314``)."""
    mesh = make_mesh()
    planes = [torch.from_numpy(p) for p in _planes(0, 8, 8)]
    params = SVGFParams(iterations=5, radius=1, luma_only_from=3)
    with pytest.raises(NotImplementedError, match="luma_only_from"):
        sharded.svgf_spatial_local(*planes, 8, 8, mesh=mesh, params=params,
                                   impl="auto")
    with pytest.raises(ValueError, match="bwd_impl='stored'"):
        sharded.svgf_spatial_chained_local(*planes, 8, 8, mesh=mesh,
                                           params=params,
                                           bwd_impl="recompute")
    with pytest.raises(ValueError, match="stored bwd_impl"):
        sharded.svgf_spatial_chained_local(
            *planes, 8, 8, mesh=mesh, params=SVGFParams(iterations=2),
            weight_math="fast", bwd_impl="recompute")


def test_history_carry_type_errors():
    """The canvas paths reject a History carry with a targeted message, and
    back; a non-divisible shape has no canvas
    (``tests/test_sharded.py:353``)."""
    from raymarchdenoisercuda_torch.ops.raymarch import (cornell_camera,
                                                         cornell_scene)

    mesh = make_mesh()
    sv = SVGFParams(iterations=2, max_motion=3)
    kw = dict(cam_cfg=CameraParams(width=16, height=12),
              rm_params=RaymarchParams(max_steps=8, shadow_steps=4),
              svgf_params=sv)
    run = sharded.make_sharded_pipeline(mesh, 12, 16, **kw)
    scene, cam = cornell_scene(device="cpu"), cornell_camera(device="cpu")
    with pytest.raises(TypeError, match="init_history_canvas"):
        run(scene, cam, cam, History.zeros(12, 16, device="cpu"))
    run_tile = sharded.make_sharded_pipeline(mesh, 12, 16, temporal_impl="ad",
                                             **kw)
    with pytest.raises(TypeError, match="History carry"):
        run_tile(scene, cam, cam, sharded.init_history_canvas(
            mesh, 12, 16, sv, device="cpu"))
    with pytest.raises(ValueError, match="mesh-divisible"):
        sharded.init_history_canvas(dataclasses.replace(mesh, shape=(1, 2, 2)),
                                    33, 32, sv)
    with pytest.raises(ValueError, match="bounded motion"):
        sharded.init_history_canvas(mesh, 12, 16,
                                    SVGFParams(max_motion=None))


def test_init_history_canvas_defaults_to_the_card():
    """The canvas carry is made on the CUDA card unless the caller asks for
    the CPU, as the port's other constructors are."""
    mesh, sv = make_mesh(), SVGFParams(iterations=2, max_motion=3)
    assert sharded.init_history_canvas(mesh, 12, 16, sv,
                                       device="cpu").shape == (10, 20, 24)
    if torch.cuda.is_available():
        assert sharded.init_history_canvas(mesh, 12, 16, sv).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sharded.init_history_canvas(mesh, 12, 16, sv)
