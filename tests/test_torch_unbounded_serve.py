"""Serving with unbounded reprojection (``SVGFParams(max_motion=None)``):
the port's frame against the benchmark's plain reference of that step
(``benchmark/reference/denoise_unbounded.py``), that reference against
the frozen bounded one where the two agree by construction, and the spans
and counters the route records.

Tolerances, each with its reason:

* the plain path against the reference over 3 chained frames (40x56, the
  CPU): denoised frame rtol 1e-5, atol 1e-6, history colour and moments
  rtol 1e-5, atol 1e-6, length exact.  The reprojection and the epilogue
  are the same operations in the same order on both sides (the gather's
  blends rounded as fused multiply-adds, so the history lengths, which
  integer-valued tests read, agree to the bit); the à-trous sweeps differ
  in the order of their sums, ~1e-7 a level, the bounded cells' tolerance
  in ``benchmark/tests/test_bench_reference.py``;
* the new reference against the bounded one at |motion| <= 6 with every
  tap inside the frame: with integer motion every tap weight is 0 or 1 and
  both gathers are exact, so the whole frame is bit-equal; at fractional
  motion the two gathers round their four products in another order
  (four fused multiply-adds from zero, against two rows' blends and a
  column blend), so the reprojected planes agree to rtol 1e-6, atol 1e-6
  times their largest value (a few float32 roundings);
* the card route (``impl="auto"``: K3's unbounded step, the clamped
  gather in K3's body; K1 for the sweep) against the reference computed
  on the card, 1920x1080, motion to ±40 px: history moments rtol 1e-5,
  atol 1e-6 (the epilogue's operations are the reference's, in its
  order; the gather's ``fmaf`` against the reference's float64 sum
  rounded once can differ by an ulp where the double rounding falls),
  length atol 1e-5 (an ulp of a length up to ~40); denoised
  frame and history colour atol 1e-3 times their largest value, the
  existing card test's tolerance for the frame (K1's exact weights are
  an ulp from ``torch.exp``'s, over five levels).

On the card the route makes no synchronising call (CUDA's sync debug
mode at "error" around a frame).
"""

import numpy as np
import pytest
import torch

from benchmark.reference import denoise as ref_bounded
from benchmark.reference import denoise_unbounded as ref
from raymarchdenoisercuda_torch.config import SVGFParams
from raymarchdenoisercuda_torch.gbuffer import GBuffer, History
from raymarchdenoisercuda_torch.models.svgf import svgf_denoise_frame
from raymarchdenoisercuda_torch.utils import timing

H, W = 40, 56
FRAMES = 3
BOUND = SVGFParams().max_motion
PARAMS = SVGFParams(max_motion=None)
REF_PARAMS = dict(iterations=5, radius=2, sigma_color=4.0,
                  sigma_normal=128.0, sigma_depth=1.0, temporal_alpha=0.2,
                  temporal_moments_alpha=0.2, history_clamp=True,
                  variance_boost_frames=4, feedback_level=1, max_motion=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gbuffer(rng, h, w, reach, integer=False, device="cpu"):
    """A random G-buffer: a render with emissive pixels, normals near the
    camera's axis and depths within 5 % (so that most histories pass the
    validity tests), motion uniform in ±``reach`` px."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    n = rng.standard_normal((3, h, w)) * 0.2
    n[2] -= 1.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    albedo = rng.random((3, h, w))
    albedo[:, rng.random((h, w)) < 0.05] = 0.0
    motion = (rng.random((2, h, w)) * 2 - 1) * reach
    if integer:
        motion = np.round(motion)
    return dict(render=t(rng.random((3, h, w)) * 2), albedo=t(albedo),
                normal=t(n), depth=t(1.0 + 0.05 * rng.random((h, w))),
                motion=t(motion))


def history(rng, h, w, device="cpu"):
    """A random history: lengths 0-6 (whole numbers), its depth and
    normal near the G-buffer's."""
    g = gbuffer(rng, h, w, 0, device=device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return dict(color=t(rng.random((3, h, w))),
                moments=t(rng.random((2, h, w))),
                length=t(rng.integers(0, 7, (h, w))),
                prev_depth=g["depth"], prev_normal=g["normal"])


def program_frame(g, hist, impl="plain", params=PARAMS):
    gb = GBuffer(**g, denoised=None)
    with torch.no_grad():
        out, new = svgf_denoise_frame(gb, History(**hist), params=params,
                                      impl=impl)
    return out.denoised, dict(color=new.color, moments=new.moments,
                              length=new.length, prev_depth=new.prev_depth,
                              prev_normal=new.prev_normal)


def test_plain_path_matches_the_reference_over_chained_frames():
    rng = np.random.default_rng(2026)
    hist = history(rng, H, W)
    ref_hist = dict(hist)
    far = 0
    for _ in range(FRAMES):
        g = gbuffer(rng, H, W, 18.0)
        m = g["motion"].abs()
        far += int(((m[0] > BOUND) | (m[1] > BOUND)).sum())
        den, hist = program_frame(g, hist)
        want, ref_hist = ref.denoise(g, ref_hist, REF_PARAMS)
        torch.testing.assert_close(den, want, rtol=1e-5, atol=1e-6)
        for k in ("color", "moments"):
            torch.testing.assert_close(hist[k], ref_hist[k], rtol=1e-5,
                                       atol=1e-6, msg=k)
        assert torch.equal(hist["length"], ref_hist["length"])
        # the chain keeps histories from beyond the default bound
        taken_far = ((hist["length"] > 1)
                     & ((m[0] > BOUND) | (m[1] > BOUND))).sum()
        assert taken_far > 0
    # most pixels moved past the bound, many of them out of the frame
    assert far > 0.6 * FRAMES * H * W


def inside_taps(motion, h, w):
    """The pixels whose |motion| is within the default bound and whose four
    bilinear taps all lie inside the frame."""
    iy = torch.arange(h)[:, None].float()
    ix = torch.arange(w)[None, :].float()
    ys, xs = iy + motion[0], ix + motion[1]
    return ((motion.abs() <= BOUND).all(0) & (ys >= 0) & (xs >= 0)
            & (torch.floor(ys) + 1 <= h - 1) & (torch.floor(xs) + 1 <= w - 1))


def test_the_reference_equals_the_bounded_one_within_the_bound():
    rng = np.random.default_rng(7)
    g = gbuffer(rng, H, W, BOUND, integer=True)
    hist = history(rng, H, W)
    bounded = dict(REF_PARAMS, max_motion=BOUND)
    den_b, hist_b = ref_bounded.denoise(g, hist, bounded)
    den_u, hist_u = ref.denoise(g, hist, REF_PARAMS)
    assert torch.equal(den_b, den_u)
    for k in ("color", "moments", "length"):
        assert torch.equal(hist_b[k], hist_u[k]), k

    g = gbuffer(rng, H, W, BOUND + 0.9)
    stack = torch.from_numpy(0.5 + rng.random((10, H, W)).astype(np.float32))
    inside = inside_taps(g["motion"], H, W)
    assert inside.float().mean() > 0.5
    got = ref.reproject_clamped(stack, g["motion"])
    want = ref_bounded.reproject(stack, g["motion"], BOUND)
    torch.testing.assert_close(got[:, inside], want[:, inside], rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    # beyond the bound the bounded gather reads zero; this one reads on
    beyond = (g["motion"].abs() > BOUND).any(0)
    assert (want[:, beyond] == 0).all()
    assert (got[:, beyond] > 0).all()


def records_of(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return list(timing.RECORDER.records), timing.report()


@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_the_unbounded_route_records_its_spans_and_counters(impl):
    rng = np.random.default_rng(11)
    frames = [gbuffer(rng, H, W, 18.0) for _ in range(FRAMES)]
    state = dict(hist=history(rng, H, W), far=0)

    def run():
        for g in frames:
            _, state["hist"] = program_frame(g, state["hist"], impl)
            m = g["motion"].abs()
            state["far"] += int(((state["hist"]["length"] > 1)
                                 & ((m[0] > BOUND) | (m[1] > BOUND))).sum())

    records, rep = records_of(run)
    for name in ("rdt.temporal.gather", "rdt.temporal.epilogue"):
        recs = [r for r in records if r.name == name]
        assert len(recs) == FRAMES, name
        assert all(r.parent is not None and r.parent.name == "rdt.temporal"
                   for r in recs), name
        assert rep["spans"][name]["count"] == FRAMES
    c = rep["counters"]
    assert c["temporal_unbounded"] == FRAMES
    assert c["reprojected_far_px"] == state["far"] > 0
    assert c["pixels"] == FRAMES * H * W


def test_the_fused_route_counts_every_unbounded_step():
    """``impl="auto"`` takes K3's unbounded step (on the CPU its twin):
    each frame adds one to ``temporal_unbounded_fused`` and one to
    ``temporal_unbounded``; a bounded frame adds to neither."""
    rng = np.random.default_rng(13)
    frames = [gbuffer(rng, H, W, 18.0) for _ in range(FRAMES)]
    state = dict(hist=history(rng, H, W))

    def run():
        for g in frames:
            _, state["hist"] = program_frame(g, state["hist"], "auto")

    _, rep = records_of(run)
    c = rep["counters"]
    assert c["temporal_unbounded_fused"] == c["temporal_unbounded"] == FRAMES
    g, hist = gbuffer(rng, H, W, 18.0), history(rng, H, W)
    _, rep = records_of(lambda: program_frame(g, hist, "auto",
                                              params=SVGFParams()))
    assert not rep["counters"].keys() & {"temporal_unbounded",
                                         "temporal_unbounded_fused"}


def test_a_bounded_frame_records_neither():
    rng = np.random.default_rng(12)
    g, hist = gbuffer(rng, H, W, 18.0), history(rng, H, W)
    records, rep = records_of(lambda: program_frame(g, hist,
                                                    params=SVGFParams()))
    names = {r.name for r in records}
    assert "rdt.temporal" in names
    assert not names & {"rdt.temporal.gather", "rdt.temporal.epilogue"}
    assert "temporal_unbounded" not in rep["counters"]
    assert "reprojected_far_px" not in rep["counters"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the clamped-gather route's "
                    "kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_card_route_matches_the_reference_at_1080p(dev):
    from raymarchdenoisercuda_torch.ops.temporal_cuda import (
        clamped_gather_cuda, history_stack_channel_minor_cuda,
        temporal_accumulate_cuda)
    h, w = 1080, 1920
    rng = np.random.default_rng(1080)
    g = gbuffer(rng, h, w, 40.0, device=dev)
    hist = history(rng, h, w, device=dev)
    before = (clamped_gather_cuda.launches,
              history_stack_channel_minor_cuda.launches,
              temporal_accumulate_cuda.launches)
    den, new = program_frame(g, hist, impl="auto")
    # one launch of K3's unbounded step, no KG or KGp
    assert clamped_gather_cuda.launches == before[0]
    assert history_stack_channel_minor_cuda.launches == before[1]
    assert temporal_accumulate_cuda.launches == before[2] + 1
    with torch.no_grad():
        want, ref_hist = ref.denoise(g, hist, REF_PARAMS)
    torch.testing.assert_close(new["moments"], ref_hist["moments"],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new["length"], ref_hist["length"], rtol=0,
                               atol=1e-5)
    for got, ref_plane in ((den, want), (new["color"], ref_hist["color"])):
        torch.testing.assert_close(
            got, ref_plane, rtol=0,
            atol=1e-3 * float(ref_plane.abs().max()))
    taken = ((new["length"] > 1)
             & (g["motion"].abs() > BOUND).any(0)).float().mean()
    assert taken > 0.2


@pytest.mark.cuda
def test_the_card_route_makes_no_host_sync(dev):
    """The plain epilogue makes its constants on the device
    (``torch.full``, not ``torch.tensor`` of a Python number, which copies
    from the host): with CUDA's sync debug mode at "error" a frame on the
    route raises on any synchronising call, and makes none."""
    rng = np.random.default_rng(270)
    g = gbuffer(rng, 270, 480, 40.0, device=dev)
    hist = history(rng, 270, 480, device=dev)
    program_frame(g, hist, impl="auto")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        den, _ = program_frame(g, hist, impl="auto")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.isfinite(den).all()
