"""The numbers that decide ``correct``, each compared with its limit.

Serving (a frame at a time, from scratch or from the program's history):

* ``gbuf_mismatch_pct``: the share of pixels, in %, at which the program's
  G-buffer departs from the reference's beyond the planes' tolerances
  (``GBUF_TOL``), over the compared frames (the largest);
* ``denoised_mismatch_pct``: the same for the denoised frame;
* ``history_mismatch_pct``: the same for the new history's colour (the
  feedback level's output), moments and length.

Training (the first steps, from the same start as the program):

* ``loss_gap``: the largest |L_program − L_reference| / |L_reference| over
  the compared steps;
* ``grad_gap``: |‖g‖ − ‖g_ref‖| / ‖g_ref‖ of the first step's gradient of
  the albedo table (the one leaf), the program's taken from Adam's first
  moment after one step;
* ``update_gap``: the same gap for the change of the table over the
  compared steps;
* ``history_mismatch_pct`` as above, after the first step (before Adam
  has moved the table: a material whose gradient is a cancellation moves
  by its sign, and an emissive pixel's demodulated colour scales with
  1/albedo, so a later history would judge Adam's round-off).

A pixel departs where any channel of a plane has |p − r| > atol + rtol·|r|
or is not finite.  The tolerances sit far above float32 rounding (~1e-7
relative) and far below bfloat16's (~4e-3): a departing pixel is a tie
(a ray that grazes an edge or a shadow boundary takes the other side), or
a fault.
"""

from __future__ import annotations

import torch

# plane: (atol, rtol)
GBUF_TOL = {"render": (1e-4, 1e-3), "albedo": (1e-6, 0.0),
            "normal": (1e-3, 0.0), "depth": (1e-4, 1e-4),
            "motion": (1e-2, 0.0)}
DENOISED_TOL = {"denoised": (1e-4, 1e-3)}
HISTORY_TOL = {"color": (1e-4, 1e-3), "moments": (1e-4, 1e-3),
               "length": (1e-3, 0.0)}


def departing(program: dict, reference: dict, tol: dict) -> torch.Tensor:
    """(H, W) mask of the pixels where any plane named in ``tol`` departs."""
    bad = None
    for name, (atol, rtol) in tol.items():
        p = program[name].to(reference[name].device, torch.float32)
        r = reference[name].to(torch.float32)
        d = ~(torch.abs(p - r) <= atol + rtol * torch.abs(r))
        if d.dim() == 3:
            d = d.any(0)
        bad = d if bad is None else bad | d
    return bad


def mismatch_pct(program: dict, reference: dict, tol: dict) -> float:
    return 100.0 * float(departing(program, reference, tol).float().mean())


def norm_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """|‖p‖ − ‖r‖| / ‖r‖ (the gap of the norms, not the norm of the gap)."""
    rn = float(torch.linalg.vector_norm(reference.double()))
    pn = float(torch.linalg.vector_norm(program.double()))
    if not torch.isfinite(program).all():
        return float("inf")
    return abs(pn - rn) / rn if rn > 0 else (0.0 if pn == 0 else
                                             float("inf"))


def rel_gap(p: float, r: float) -> float:
    if p != p:
        return float("inf")
    return abs(p - r) / abs(r) if r != 0 else (0.0 if p == 0 else
                                               float("inf"))


def verdict(numbers: dict, limits: dict):
    """``(correct, [(name, value, limit, ok)])``: every number at or under
    its limit; a number without a limit fails."""
    rows = []
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value == value and value <= limit
        rows.append((name, value, limit, ok))
    return all(r[3] for r in rows), rows
