"""The port's halo exchange (``parallel/halo.py``) on gloo process groups,
against the JAX package's ``exchange_rows``/``exchange_cols``/
``exchange_halo2d`` under ``shard_map`` on the virtual CPU devices and
against a zero pad of the global image, mirroring
``tests/test_parallel_units.py``.

Each mesh shape spawns one group (``tests/_torch_sharded_workers.py``):
(1, 2, 2); (1, 2, 4), whose 8x4 tiles are narrower than the 12-wide halo
(multi-hop on both axes); (2, 1, 2), a data axis.  The exchanged tiles are
copies, so they agree exactly; the gradient of Σ w·padded (the exchange's
transpose: each halo cotangent added back to its owner's edge) agrees to
rtol 1e-6 (the additions' order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from raymarchdenoisercuda_tpu.parallel import halo as jhalo
from raymarchdenoisercuda_tpu.parallel.mesh import make_mesh as j_make_mesh
from raymarchdenoisercuda_torch.parallel import distributed
from raymarchdenoisercuda_torch.parallel.halo import (
    exchange_halo2d, tile_origin)
from raymarchdenoisercuda_torch.parallel.mesh import (
    factor2, make_mesh, shard_plane, unshard_plane)

from _torch_sharded_workers import run_group

MESHES = [(1, 2, 2), (1, 2, 4), (2, 1, 2)]
HALOS = (2, 3, 12)
KINDS = dict(rows=jhalo.exchange_rows, cols=jhalo.exchange_cols,
             both=jhalo.exchange_halo2d)
N = 16


def _padded_shape(kind, h, th, tw):
    return (th + (2 * h if kind != "cols" else 0),
            tw + (2 * h if kind != "rows" else 0))


def _jax_exchange(x, weights, kind, h, mesh_shape):
    """JAX's exchange of ``x`` on the same mesh (tiles side by side) and
    the gradient of Σ weights·exchanged."""
    d, ny, nx = mesh_shape
    mesh = j_make_mesh(d * ny * nx, data=d)
    fn = shard_map(lambda t: KINDS[kind](t, h), mesh=mesh,
                   in_specs=P(None, "y", "x"), out_specs=P(None, "y", "x"),
                   check_vma=False)
    out = fn(jnp.asarray(x))
    grad = jax.grad(lambda t: jnp.sum(fn(t) * weights))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_halo_exchange_matches_jax_and_the_global_pad(tmp_path, mesh_shape):
    d, ny, nx = mesh_shape
    th, tw = N // ny, N // nx
    rng = np.random.default_rng(ny * 10 + nx + d)
    x = rng.random((2, N, N), dtype=np.float32)
    weights = {}
    for kind in KINDS:
        for h in HALOS:
            ph, pw = _padded_shape(kind, h, th, tw)
            weights[kind, h] = rng.standard_normal(
                (2, ny * ph, nx * pw)).astype(np.float32)
    results = run_group(tmp_path, mesh_shape, "halo_worker", x=x,
                        halos=HALOS, weights=weights)
    for kind in KINDS:
        for h in HALOS:
            hy = h if kind != "cols" else 0
            hx = h if kind != "rows" else 0
            ph, pw = th + 2 * hy, tw + 2 * hx
            xp = np.pad(x, ((0, 0), (hy, hy), (hx, hx)))
            j_out, j_grad = _jax_exchange(x, weights[kind, h], kind, h,
                                          mesh_shape)
            for r, res in enumerate(results):
                iy, ix = (r // nx) % ny, r % nx
                got = res[f"{kind}{h}"]
                np.testing.assert_array_equal(
                    got, xp[:, iy * th:iy * th + ph, ix * tw:ix * tw + pw])
                np.testing.assert_array_equal(
                    got, j_out[:, iy * ph:(iy + 1) * ph,
                               ix * pw:(ix + 1) * pw])
                np.testing.assert_allclose(res[f"grad_{kind}{h}"], j_grad,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{kind} halo {h}")


def test_one_tile_exchange_is_a_zero_pad_and_its_adjoint_a_crop():
    """Without a process group the mesh is (1, 1, 1): no communication, a
    zero pad (``halo.py:42-49`` of the JAX package), gradients cropped."""
    mesh = make_mesh()
    assert mesh.shape == (1, 1, 1) and not mesh.distributed
    assert tile_origin((5, 7), mesh) == (0, 0)
    x = torch.rand((3, 6, 9), requires_grad=True)
    y = exchange_halo2d(x, 4, mesh)
    assert y.shape == (3, 14, 17)
    assert torch.equal(y[:, 4:10, 4:13], x)
    assert float(y.detach().sum()) == pytest.approx(
        float(x.detach().sum()))
    w = torch.rand(y.shape)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w[:, 4:10, 4:13])
    assert torch.equal(shard_plane(mesh, x.detach()), x.detach())
    assert unshard_plane(mesh, x) is x


def test_mesh_shapes_and_single_process_runtime(monkeypatch):
    assert factor2(8) == (2, 4)
    assert factor2(16) == (4, 4)
    assert factor2(7) == (1, 7)
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(4)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(1, data=2)
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False    # alone: no group
    info = distributed.runtime_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["platform"] in ("cpu", "gpu")
