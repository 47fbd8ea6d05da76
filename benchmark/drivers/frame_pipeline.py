"""Serving: the program's ``FramePipeline`` renders and denoises one orbit
frame a unit through ``FramePipeline.forward``, the history chained from
frame to frame; the chain's first frame starts from an empty history and
no previous camera.

``check`` compares the chain's first frame (from scratch) and the window's
last frame (from the program's own history) with the reference, each the
whole frame.  Faults: the history returned unchanged; the lower half of
the denoised frame left as the noisy render; a block of a sixteenth of
the frame's width and height of the denoised frame set to 0.  Controls:
the reference in bfloat16 in the program's place, and the program's own
bfloat16 sweep (``precision="bf16"``).
"""

from __future__ import annotations

import torch

from .. import check as checks
from .. import traffic as traffic_gen
from ..reference import denoise as ref_denoise
from ..reference import render as ref_render
from . import (GBUF_PLANES, HIST_PLANES, Program, host, patched,
               reference_camera, reference_scene)

PROGRAM_CONTROLS = {"control_program_bf16": {"precision": "bf16"}}


class Driver(Program):

    unit = "frame"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from raymarchdenoisercuda_torch.gbuffer import History
        from raymarchdenoisercuda_torch.models.pipeline import FramePipeline
        self.pipe = FramePipeline(
            self.scene, self.cam_cfg, self.rm, self.svgf,
            weight_math=config["weight_math"], impl="auto",
            precision=config["precision"])
        self.hist = History.zeros(self.H, self.W, device=self.device)
        self.k0 = traffic_gen.first_frame(traffic, seed)
        self.count = 0
        self.last = None
        self.first = None

    def dispatch(self, _n=None):
        """One frame of the chain.  The previous frame's record is dropped
        before the call, so only what the chain holds is alive during it."""
        k = self.k0 + self.count
        cam = self.camera(k)
        prev = self.camera(k - 1) if self.count else None
        state = self.gen.get_state()
        hist_in = self.hist
        self.last = None
        with torch.no_grad():
            out, self.hist = self.pipe(cam, prev, hist_in, self.gen)
        self.last = dict(k=k, has_prev=prev is not None, state=state,
                         hist_in=vars(hist_in), out=vars(out),
                         hist_out=vars(self.hist))
        self.count += 1

    def setup(self):
        """The traffic's warm-up frames; the chain's first frame is kept on
        the host for the check."""
        for i in range(int(self.traffic["warmup"])):
            self.dispatch()
            if i == 0:
                rec = self.last
                self.first = dict(
                    k=rec["k"], has_prev=False, state=rec["state"],
                    hist_in=None,
                    out=host(rec["out"], GBUF_PLANES + ("denoised",)),
                    hist_out=host(rec["hist_out"], HIST_PLANES))

    def release(self):
        """Drop the program's state that the check does not read."""
        self.hist = None
        self.pipe = None

    def check(self) -> dict:
        """The numbers of the chain's first frame and of the window's last
        frame, the larger of each."""
        length = self.last["hist_out"]["length"]
        self.notes.append(
            f"reprojected: {100.0 * float((length > 1).float().mean()):.4f}"
            f" % of the pixels of the window's last frame (orbit frame "
            f"{self.last['k'] % len(self.cameras)}) took their history")
        numbers = {}
        for rec in (self.first, self.last):
            for name, value in self.numbers(rec).items():
                numbers[name] = max(numbers.get(name, 0.0), value)
        return numbers

    def reference_frame(self, rec: dict, dtype=torch.float32):
        """The reference's G-buffer, denoised frame and new history of the
        frame of ``rec``: from its camera, the light points redrawn from
        its generator state, and its input history (empty on the chain's
        first frame), in ``dtype``."""
        dev = self.device
        scene = reference_scene(self.arrays, dev, dtype)
        cam = reference_camera(self.traffic, rec["k"], dev, dtype)
        prev = (reference_camera(self.traffic, rec["k"] - 1, dev, dtype)
                if rec["has_prev"] else None)
        with torch.no_grad():
            g = ref_render.render(scene, cam, prev,
                                  self.ref_generator(rec["state"]),
                                  self.ref_cfg(), self.config["raymarch"])
            if rec["hist_in"] is None:
                hist = ref_denoise.zero_history(self.H, self.W, dtype=dtype,
                                                device=dev)
            else:
                hist = {k: v.to(dtype) for k, v in rec["hist_in"].items()}
            g["denoised"], new_hist = ref_denoise.denoise(
                g, hist, self.config["svgf"])
        return g, new_hist

    def numbers(self, rec: dict) -> dict:
        """A frame's numbers: ``rec``'s outputs against the reference's."""
        g, new_hist = self.reference_frame(rec)
        return {
            "gbuf_mismatch_pct": checks.mismatch_pct(rec["out"], g,
                                                     checks.GBUF_TOL),
            "denoised_mismatch_pct": checks.mismatch_pct(
                rec["out"], g, checks.DENOISED_TOL),
            "history_mismatch_pct": checks.mismatch_pct(
                rec["hist_out"], new_hist, checks.HISTORY_TOL),
        }


def control_numbers(d: Driver) -> dict:
    """The reference in bfloat16 in the program's place, on the frames the
    check compared."""
    out = {}
    for rec in (d.first, d.last):
        g, h = d.reference_frame(rec, torch.bfloat16)
        fake = dict(rec, out={k: v.float() for k, v in g.items()},
                    hist_out={k: v.float() for k, v in h.items()})
        for name, value in d.numbers(fake).items():
            out[name] = max(out.get(name, 0.0), value)
    return out


def _wrap(transform):
    """``FramePipeline.forward`` with ``transform(out, history_in,
    history_out) -> (out, history)`` applied to what it returns."""
    from raymarchdenoisercuda_torch.models.pipeline import FramePipeline
    forward = FramePipeline.forward

    def wrapped(self, camera, prev_camera, history, generator=None,
                light_sample=None):
        out, new_hist = forward(self, camera, prev_camera, history,
                                generator, light_sample)
        return transform(out, history, new_hist)

    return patched(FramePipeline, "forward", wrapped)


def stale_state():
    return _wrap(lambda out, hist, new: (out, hist))


def half_batch():
    def cut(out, hist, new):
        H = out.denoised.shape[-2]
        den = out.denoised.clone()
        den[:, H // 2:] = out.render[:, H // 2:]
        return out.replace(denoised=den), new
    return _wrap(cut)


def altered_answer():
    def alter(out, hist, new):
        H, W = out.denoised.shape[-2:]
        den = out.denoised.clone()
        den[:, H // 3:H // 3 + max(H // 16, 1),
            W // 3:W // 3 + max(W // 16, 1)] = 0.0
        return out.replace(denoised=den), new
    return _wrap(alter)


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
