"""The frozen reference against the port's plain path (``impl="plain"``) at
a small size on the CPU: the same G-buffer, the same denoised frame and
history, the same training steps.  The test may import the port; the
reference does not."""

import dataclasses

import pytest
import torch

from benchmark import cell as cells
from benchmark import drivers
from benchmark import traffic as gen
from benchmark.reference import denoise as ref_denoise
from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train

H, W = 40, 56


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program(cell_name, seed=3):
    c = cells.resolve(cells.load_spec(), cell_name)
    cfg = dict(c.config, width=W, height=H)
    return drivers.make(cfg, c.traffic, seed, "cpu")


def ref_inputs(p, frame):
    return (drivers.reference_scene(p.arrays, "cpu"),
            drivers.reference_camera(p.traffic, frame, "cpu"))


def assert_planes_close(got, want, names, rtol=1e-6, atol=1e-6):
    for k in names:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol,
                                   msg=k)


@pytest.mark.parametrize("cell_name", ["serve_4k_cornell",
                                       "serve_4k_clutter"])
def test_render_and_denoise_match_the_plain_path(cell_name):
    from raymarchdenoisercuda_torch.gbuffer import History
    from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
    from raymarchdenoisercuda_torch.ops.raymarch import render_gbuffer
    p = program(cell_name)
    hist = History.zeros(H, W, device="cpu")
    ref_hist = ref_denoise.zero_history(H, W, dtype=torch.float32,
                                        device="cpu")
    for k in (5, 6, 7):
        state = p.gen.get_state()
        g = render_gbuffer(p.scene, p.camera(k), p.camera(k - 1), p.gen,
                           cam_cfg=p.cam_cfg, params=p.rm, impl="plain")
        scene, cam = ref_inputs(p, k)
        prev = drivers.reference_camera(p.traffic, k - 1, "cpu")
        rg = ref_render.render(scene, cam, prev, p.ref_generator(state),
                               p.ref_cfg(), p.config["raymarch"],
                               block_rows=16)
        assert_planes_close(vars(g), rg, drivers.GBUF_PLANES)
        out, hist = svgf_denoise_frame(g, hist, params=p.svgf,
                                       impl="plain")
        den, ref_hist = ref_denoise.denoise(rg, ref_hist,
                                            p.config["svgf"])
        torch.testing.assert_close(out.denoised, den, rtol=1e-5, atol=1e-6)
        assert_planes_close(vars(hist), ref_hist,
                            ("color", "moments", "length"), rtol=1e-5)


def test_training_steps_match_the_plain_path():
    from raymarchdenoisercuda_torch.models.pipeline import (
        init_train_state, make_train_step)
    p = program("train_4k_cornell")
    step = make_train_step(p.scene, p.camera(0), p.target,
                           cam_cfg=p.cam_cfg, rm_params=p.rm,
                           svgf_params=p.svgf, impl="plain")
    state = init_train_state(p.albedo0, H, W, p.gen, lr=p.traffic["lr"])
    gen_state = p.gen.get_state()
    got = []
    for i in range(3):
        state, loss = step(state)
        got.append((float(loss), state.albedo.grad.clone(),
                    state.albedo.detach().clone()))
        if i == 0:
            ph = {f.name: getattr(state.history, f.name)
                  for f in dataclasses.fields(state.history)}
    scene, cam = ref_inputs(p, 0)
    want, hist = ref_train.train(scene, cam, p.target, p.albedo0,
                                 p.ref_generator(gen_state), p.ref_cfg(),
                                 p.config["raymarch"], p.config["svgf"],
                                 p.traffic["lr"], 3)
    for (loss, grad, table), (rl, rg, rt) in zip(got, want):
        assert loss == pytest.approx(float(rl), rel=1e-6)
        torch.testing.assert_close(grad, rg, rtol=1e-3, atol=1e-7)
        torch.testing.assert_close(table, rt, rtol=1e-5, atol=1e-6)
    assert_planes_close(ph, hist, ("color", "moments", "length"), rtol=1e-5)


def test_the_light_draw_is_the_programs():
    from raymarchdenoisercuda_torch.ops.raymarch import sample_light
    p = program("serve_4k_cornell", seed=2**31 + 5)
    state = p.gen.get_state()
    want = sample_light(p.scene, p.gen, (H, W))
    scene, _ = ref_inputs(p, 0)
    got = ref_render.light_sample(scene, p.ref_generator(state), H, W)
    assert torch.equal(got, want)


def test_row_blocks_give_the_whole_frame():
    p = program("serve_4k_clutter")
    scene, cam = ref_inputs(p, 2)
    prev = drivers.reference_camera(p.traffic, 1, "cpu")
    state = p.gen.get_state()
    whole = ref_render.render(scene, cam, prev, p.ref_generator(state),
                              p.ref_cfg(), p.config["raymarch"],
                              block_rows=H)
    blocks = ref_render.render(scene, cam, prev, p.ref_generator(state),
                               p.ref_cfg(), p.config["raymarch"],
                               block_rows=7)
    for k in whole:
        assert torch.equal(whole[k], blocks[k]), k
    assert gen.first_frame(p.traffic, 3) in range(p.traffic["camera"]["period"])


def test_a_step_from_the_programs_state_matches_the_plain_path():
    """The window's last step is checked from the program's state before
    it: Adam's moments and count, the history, the generator state."""
    from raymarchdenoisercuda_torch.models.pipeline import (
        init_train_state, make_train_step)
    p = program("train_4k_clutter", seed=2**31 + 7)
    step = make_train_step(p.scene, p.camera(0), p.target,
                           cam_cfg=p.cam_cfg, rm_params=p.rm,
                           svgf_params=p.svgf, impl="plain")
    state = init_train_state(p.albedo0, H, W, p.gen, lr=p.traffic["lr"])
    for _ in range(4):
        state, _ = step(state)
    held = state.optimizer.state[state.albedo]
    before = (state.albedo.detach().clone(), held["exp_avg"].clone(),
              held["exp_avg_sq"].clone(), int(held["step"]))
    hist_in = {f.name: getattr(state.history, f.name)
               for f in dataclasses.fields(state.history)}
    gen_state = p.gen.get_state()
    state, loss = step(state)
    scene, cam = ref_inputs(p, 0)
    want, hist = ref_train.train(
        scene, cam, p.target, before[0], p.ref_generator(gen_state),
        p.ref_cfg(), p.config["raymarch"], p.config["svgf"],
        p.traffic["lr"], 1, hist=hist_in, adam=before[1:])
    rl, rg, rt = want[0]
    assert float(loss) == pytest.approx(float(rl), rel=1e-6)
    torch.testing.assert_close(state.albedo.grad, rg, rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(state.albedo.detach(), rt, rtol=1e-5,
                               atol=1e-6)
    assert before[3] == 4 and not torch.equal(rt, before[0])
    got = {f.name: getattr(state.history, f.name)
           for f in dataclasses.fields(state.history)}
    assert_planes_close(got, hist, ("color", "moments", "length"), rtol=1e-5)
