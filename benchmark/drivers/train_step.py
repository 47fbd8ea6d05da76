"""Material training: one step of ``make_train_step``'s ``train_step`` a
unit, on one state from the seed's initial table, fitting the traffic's
target image.

``check`` compares with the reference (the numbers of
:mod:`benchmark.check`, the larger of each over the two stretches):

* the first ``COMPARED_STEPS`` steps, run in set-up through the window's
  own call, from the same start as the program: each step's loss, the
  first gradient as Adam holds it (its first moment over 1 − β1), the
  history after the first step, and the table after the compared steps;
* the window's last step, from the program's state before it (the table,
  Adam's moments and step count, the history and the generator state, all
  taken as the step was dispatched): its loss, its gradient (the leaf's
  ``.grad``), the table's change and the new history.

Faults: Adam's step does nothing; the loss the mean over the upper half
of the rows.  Control: the reference in bfloat16 in the program's place.
The program has no lower-precision training path of its own.
"""

from __future__ import annotations

import time

import torch

from .. import check as checks
from .. import traffic as traffic_gen
from ..reference import train as ref_train
from . import (HIST_PLANES, Program, host, patched, reference_camera,
               reference_scene, tensor)

COMPARED_STEPS = 3
PROGRAM_CONTROLS: dict = {}


class Driver(Program):

    unit = "step"

    def __init__(self, config, traffic, seed, device):
        t0 = time.perf_counter()
        super().__init__(config, traffic, seed, device)
        from raymarchdenoisercuda_torch.models.pipeline import (
            init_train_state, make_train_step)
        self.albedo0 = tensor(traffic_gen.initial_albedo(traffic, seed),
                              self.device, torch.float32)
        self.sync()
        t1 = time.perf_counter()
        self.target = traffic_gen.target_image(self)
        self.sync()
        t2 = time.perf_counter()
        self.train_step = make_train_step(
            self.scene, self.camera(0), self.target, cam_cfg=self.cam_cfg,
            rm_params=self.rm, svgf_params=self.svgf, impl="auto")
        t3 = time.perf_counter()
        self.state = init_train_state(self.albedo0, self.H, self.W, self.gen,
                                      lr=float(traffic["lr"]))
        self.sync()
        t4 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.notes.append(
            f"setup of the training objects: scene, cameras and initial "
            f"table {t1 - t0:.3f} s, the target ({traffic['target']}) "
            f"{t2 - t1:.3f} s, make_train_step {t3 - t2:.3f} s, "
            f"init_train_state {t4 - t3:.3f} s")
        self.state0 = None
        self.before = None
        self.loss = None
        self.record = None
        self.ref = None

    def dispatch(self, _n=None):
        """One step.  What the reference needs to follow it is taken as it
        is dispatched: the table with Adam's moments (one stack on the
        device), the step count, the generator state and the history."""
        st = self.state
        held = st.optimizer.state.get(st.albedo)
        if held:
            tables = torch.stack([st.albedo.detach(), held["exp_avg"],
                                  held["exp_avg_sq"]])
            t = held["step"].clone()
        else:   # no step taken yet: Adam starts from zeros
            a = st.albedo.detach()
            tables = torch.stack([a, torch.zeros_like(a),
                                  torch.zeros_like(a)])
            t = torch.zeros(())
        self.before = dict(tables=tables, t=t, gen=self.gen.get_state(),
                           hist=st.history)
        self.state, self.loss = self.train_step(st)

    def setup(self):
        """The compared steps, then the rest of the traffic's warm-up, on
        the state the window continues, through ``dispatch``."""
        n = max(int(self.traffic["warmup"]), COMPARED_STEPS)
        self.state0 = self.gen.get_state()
        losses = []
        t0 = time.perf_counter()
        for i in range(n):
            self.dispatch()
            if i < COMPARED_STEPS:
                losses.append(self.loss)
            if i == 0:
                opt = self.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                held = opt.state.get(self.state.albedo, {})
                m1 = held.get("exp_avg",
                              torch.zeros_like(self.state.albedo))
                grad1 = (m1 / (1.0 - beta1)).detach().clone()
                hist = host(vars(self.state.history), HIST_PLANES)
                self.sync()
                t1 = time.perf_counter()
            if i + 1 == COMPARED_STEPS:
                table = self.state.albedo.detach().clone()
        self.sync()
        self.notes.append(
            f"warm-up: the first step {t1 - t0:.3f} s, the {n - 1} others "
            f"{time.perf_counter() - t1:.3f} s")
        self.record = dict(losses=[float(x) for x in losses], grad1=grad1,
                           table=table, hist=hist)

    def release(self):
        """Keep the window's last step (its loss, gradient, the table's
        change and the history it made), then drop the program."""
        a = self.state.albedo
        self.record["last"] = dict(
            loss=float(self.loss), grad=a.grad.detach().clone(),
            change=a.detach() - self.before["tables"][0],
            hist={k: getattr(self.state.history, k) for k in HIST_PLANES})
        self.state = None
        self.train_step = None

    def reference_run(self, dtype=torch.float32) -> dict:
        """The reference's record, like the program's, in ``dtype``: the
        compared steps from the program's start, and the last step from
        the program's state before it."""
        dev = self.device
        scene = reference_scene(self.arrays, dev, dtype)
        cam = reference_camera(self.traffic, 0, dev, dtype)
        target = self.target.to(dtype)
        args = (self.ref_cfg(), self.config["raymarch"], self.config["svgf"],
                float(self.traffic["lr"]))
        with torch.enable_grad():
            steps, hist = ref_train.train(
                scene, cam, target, self.albedo0.to(dtype),
                self.ref_generator(self.state0), *args, COMPARED_STEPS)
            b = self.before
            tables = b["tables"].to(dtype)
            last, last_hist = ref_train.train(
                scene, cam, target, tables[0], self.ref_generator(b["gen"]),
                *args, 1, hist={k: v.to(dtype) for k, v in
                                vars(b["hist"]).items()},
                adam=(tables[1], tables[2], int(b["t"])))
        loss, grad, table = last[0]
        return dict(losses=[float(s[0]) for s in steps],
                    grad1=steps[0][1].float(), table=steps[-1][2].float(),
                    hist={k: hist[k].float() for k in HIST_PLANES},
                    last=dict(loss=float(loss), grad=grad.float(),
                              change=(table - tables[0]).float(),
                              hist={k: last_hist[k].float()
                                    for k in HIST_PLANES}))

    def numbers(self, rec: dict, ref: dict) -> dict:
        last, ref_last = rec["last"], ref["last"]
        return {
            "loss_gap": max(checks.rel_gap(p, r) for p, r in
                            zip(rec["losses"] + [last["loss"]],
                                ref["losses"] + [ref_last["loss"]])),
            "grad_gap": max(checks.norm_gap(rec["grad1"], ref["grad1"]),
                            checks.norm_gap(last["grad"], ref_last["grad"])),
            "update_gap": max(
                checks.norm_gap(rec["table"] - self.albedo0,
                                ref["table"] - self.albedo0),
                checks.norm_gap(last["change"], ref_last["change"])),
            "history_mismatch_pct": max(
                checks.mismatch_pct(rec["hist"], ref["hist"],
                                    checks.HISTORY_TOL),
                checks.mismatch_pct(last["hist"], ref_last["hist"],
                                    checks.HISTORY_TOL)),
        }

    def check(self) -> dict:
        self.ref = self.reference_run()
        return self.numbers(self.record, self.ref)


def control_numbers(d: Driver) -> dict:
    """The reference in bfloat16 in the program's place, judged by the
    float32 reference, on the steps the check compared."""
    return d.numbers(d.reference_run(torch.bfloat16), d.ref)


def detail(d: Driver) -> dict:
    """Per material: |g| of the first and of the last step's gradient and
    |Δ| of the table over the compared steps and in the last step, the
    program's and the reference's (the look behind the numbers)."""
    def rows(t):
        return [float(x) for x in torch.linalg.vector_norm(
            t.double(), dim=1)]
    rec, ref = d.record, d.ref
    return {"grad_program": rows(rec["grad1"]),
            "grad_reference": rows(ref["grad1"]),
            "change_program": rows(rec["table"] - d.albedo0),
            "change_reference": rows(ref["table"] - d.albedo0),
            "last_grad_program": rows(rec["last"]["grad"]),
            "last_grad_reference": rows(ref["last"]["grad"]),
            "last_change_program": rows(rec["last"]["change"]),
            "last_change_reference": rows(ref["last"]["change"])}


def stale_state():
    return patched(torch.optim.Adam, "step", lambda self, closure=None: None)


class _HalfMean:
    """``torch`` as the training step sees it, but ``mean`` takes the
    upper half of the rows."""

    def __init__(self, torch_module):
        self._torch = torch_module

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def mean(self, x, *args, **kw):
        return self._torch.mean(x[..., : x.shape[-2] // 2, :], *args, **kw)


def half_batch():
    from raymarchdenoisercuda_torch.models import pipeline
    return patched(pipeline, "torch", _HalfMean(torch))


FAULTS = {"stale_state": stale_state, "half_batch": half_batch}
