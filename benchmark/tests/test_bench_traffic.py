"""The traffic files' frozen data and the seeding: the scenes and the orbit
are the program's (as of when they were frozen), one seed makes the same
inputs twice and two seeds make different ones; the training target is the
reference's render of the scene's own table."""

import numpy as np
import pytest
import torch

from benchmark import cell as cells
from benchmark import drivers
from benchmark import traffic as gen
from benchmark.reference import render as ref_render

SEEDS = (2**31 + 11, 5, 123456789012)


def traffic(name):
    return cells.load_json("traffic", name)


@pytest.mark.parametrize("name,builder", [
    ("orbit_cornell", lambda m: m.cornell_scene(device="cpu")),
    ("materials_cornell", lambda m: m.cornell_scene(device="cpu")),
    ("orbit_clutter", lambda m: m.random_scene(14, 14, 12, seed=5,
                                               device="cpu")),
    ("materials_clutter", lambda m: m.random_scene(14, 14, 12, seed=5,
                                                   device="cpu"))])
def test_frozen_scene_is_the_programs(name, builder):
    from raymarchdenoisercuda_torch.ops import raymarch
    s = builder(raymarch)
    a = gen.scene_arrays(traffic(name))
    for key, t in [("spheres", s.sphere_params), ("boxes", s.box_params),
                   ("planes", s.plane_params), ("albedo", s.materials.albedo),
                   ("emission", s.materials.emission),
                   ("sphere_mat", s.sphere_mat), ("box_mat", s.box_mat),
                   ("plane_mat", s.plane_mat),
                   ("light_center", s.light_center), ("light_u", s.light_u),
                   ("light_v", s.light_v),
                   ("light_radiance", s.light_radiance)]:
        assert np.array_equal(a[key], t.numpy()), key


def test_frozen_orbit_is_the_programs():
    from raymarchdenoisercuda_torch.io.generate import orbit_camera
    cam = traffic("orbit_cornell")["camera"]
    for f in list(range(20)) + [64, 127, 130]:
        want = orbit_camera(f / cam["period"], device="cpu").position.numpy()
        assert np.array_equal(gen.camera_position(cam, f), want)
    fixed = traffic("materials_cornell")["camera"]
    assert np.array_equal(gen.camera_position(fixed, 7),
                          np.asarray([0.0, 0.0, -1.6], np.float32))


def train_driver(seed, cell_name="train_4k_clutter", h=6, w=8):
    c = cells.resolve(cells.load_spec(), cell_name)
    return drivers.make(dict(c.config, width=w, height=h), c.traffic, seed,
                        "cpu")


def inputs(seed):
    t = traffic("materials_clutter")
    scene = drivers.reference_scene(gen.scene_arrays(t), "cpu")
    lights = ref_render.light_sample(
        scene, gen.light_generator(seed, torch, "cpu"), 6, 8)
    return dict(albedo=gen.initial_albedo(t, seed),
                target=train_driver(seed).target.numpy(),
                lights=lights.numpy(),
                frame=gen.first_frame(traffic("orbit_cornell"), seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_makes_the_same_inputs(seed):
    a, b = inputs(seed), inputs(seed)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_two_seeds_make_different_inputs():
    a, b = inputs(SEEDS[0]), inputs(SEEDS[1])
    for k in ("albedo", "target", "lights"):
        assert not np.array_equal(a[k], b[k]), k
    frames = {inputs(s)["frame"] for s in range(40)}
    period = traffic("orbit_cornell")["camera"]["period"]
    assert len(frames) > 8 and frames <= set(range(period))


def test_initial_table_is_a_bounded_perturbation():
    t = traffic("materials_cornell")
    base = gen.scene_arrays(t)["albedo"]
    for seed in SEEDS:
        a = gen.initial_albedo(t, seed)
        assert a.shape == base.shape and a.dtype == np.float32
        assert np.all((a >= 0) & (a <= 1))
        assert np.all(np.abs(a - base) <= t["albedo_perturbation"] + 1e-7)


def test_the_target_is_the_reference_render_of_the_scenes_table():
    from benchmark.reference import denoise as ref_denoise
    seed = 2**31 + 99
    d = train_driver(seed, "train_4k_cornell", 12, 16)
    scene = drivers.reference_scene(d.arrays, "cpu")
    g = ref_render.render(scene, drivers.reference_camera(d.traffic, 0, "cpu"),
                          None, gen.light_generator(seed, torch, "cpu", 3),
                          d.ref_cfg(), d.config["raymarch"])
    want, _ = ref_denoise.denoise(
        g, ref_denoise.zero_history(12, 16, dtype=torch.float32,
                                    device="cpu"), d.config["svgf"])
    assert torch.equal(d.target, want)
    assert d.target.shape == (3, 12, 16) and torch.isfinite(d.target).all()
    assert float(d.target.abs().max()) > 0
    # its light draw is none of the program's: stream 3, not stream 0
    assert not torch.equal(
        ref_render.light_sample(scene, gen.light_generator(seed, torch,
                                                           "cpu", 3), 4, 4),
        ref_render.light_sample(scene, gen.light_generator(seed, torch,
                                                           "cpu"), 4, 4))


def test_a_camera_path_is_found_by_name(tmp_path, monkeypatch):
    import benchmark.cameras
    (tmp_path / "still_sway.py").write_text(
        "import numpy as np\n"
        "def position(camera, frame):\n"
        "    return np.asarray([0.01 * (frame % 2), 0, -1.6], np.float32)\n"
        "def frames(camera):\n"
        "    return 2\n"
        "def first_frame(camera, word):\n"
        "    return word % 2\n")
    monkeypatch.setattr(benchmark.cameras, "__path__",
                        list(benchmark.cameras.__path__) + [str(tmp_path)])
    t = dict(traffic("orbit_cornell"))
    t["camera"] = dict(t["camera"], path="still_sway")
    assert gen.distinct_frames(t) == 2
    assert gen.first_frame(t, 5) in (0, 1)
    assert gen.camera_position(t["camera"], 3)[0] == np.float32(0.01)
    with pytest.raises(ValueError):
        gen.part("cameras", "../orbit")
