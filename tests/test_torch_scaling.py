"""The weak-scaling harness (``parallel/scaling.py``) on gloo CPU ranks:
``weak_scaling`` over 1 rank (in this process) and 4 (a (1, 2, 2) group
that ``parallel.distributed.spawn_group`` starts, with its join and
collective timeouts).  CPU ranks share one host's cores, so their rows
are marked layout-only and their times are not held to anything.  The
layout, on a second group of 4 spawned through
``tests/_torch_sharded_workers.py``: every rank reports the slowest
rank's time, and the tiles' sweep put side by side is the unsharded sweep
of the global frame (the JAX package's ``scaling.py`` checks no more
than that its program runs at each mesh shape).  On a card's device,
more ranks than the host has cards raise."""

import numpy as np
import pytest
import torch

from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.parallel import scaling
from raymarchdenoisercuda_torch.parallel.mesh import factor2, make_mesh
from raymarchdenoisercuda_torch.parallel.sharded import svgf_spatial_local

from _torch_sharded_workers import run_group

TILE, ITERATIONS, STEPS = 16, 3, 2


def test_weak_scaling_on_one_and_four_gloo_ranks(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = scaling.weak_scaling([1, 4], tile=TILE, iterations=ITERATIONS,
                                    steps=STEPS, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert [r["devices"] for r in rows] == [1, 4]
    assert [tuple(r["mesh"]) for r in rows] == [(1, 1), (2, 2)]
    for r in rows:
        assert r["platform"] == "cpu" and r["validates"] == "layout-only"
        assert r["tile"] == [TILE, TILE] and r["sec_per_step"] > 0
        assert np.isclose(r["mpix_per_s"],
                          r["devices"] * TILE ** 2 / r["sec_per_step"] / 1e6)
    assert rows[0]["weak_efficiency"] == 1.0
    assert np.isclose(rows[1]["weak_efficiency"],
                      rows[0]["sec_per_step"] / rows[1]["sec_per_step"])

    # the layout: every rank has the slowest rank's time, and the 4 tiles'
    # sweep is the global frame's
    ny, nx = factor2(4)
    group = run_group(tmp_path, (1, ny, nx), "scaling_worker",
                      join_timeout=300, tile=TILE, iterations=ITERATIONS,
                      steps=STEPS)
    assert len({float(r["seconds"]) for r in group}) == 1
    planes = [np.zeros((3, ny * TILE, nx * TILE), np.float32),
              np.zeros((ny * TILE, nx * TILE), np.float32),
              np.zeros((3, ny * TILE, nx * TILE), np.float32),
              np.zeros((ny * TILE, nx * TILE), np.float32)]
    got = np.zeros((3, ny * TILE, nx * TILE), np.float32)
    for res in group:
        _, iy, ix = (int(c) for c in res["coords"])
        win = np.s_[..., iy * TILE:(iy + 1) * TILE, ix * TILE:(ix + 1) * TILE]
        for p, t in zip(planes, scaling._inputs(TILE, TILE, (0, iy, ix),
                                                "cpu")):
            p[win] = t.numpy()
        got[win] = res["out"]
    want, _ = svgf_spatial_local(
        *(torch.from_numpy(p) for p in planes), ny * TILE, nx * TILE,
        mesh=make_mesh(1), params=SVGFParams(iterations=ITERATIONS))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_weak_scaling_refuses_more_card_ranks_than_cards(monkeypatch):
    """Ranks on the card run one a card: asking for more than the host has
    raises before anything runs (no CPU rows in a card's table)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(scaling, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="2 ranks on the card"):
        scaling.weak_scaling([1, 2], tile=TILE, device="cuda")
