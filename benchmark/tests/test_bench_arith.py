"""The yardstick's arithmetic on synthetic inputs: the roofline count, the
percentile, the union of device intervals and its gaps, the closed loop,
and the per-layer readers on a synthetic trace."""

import math

import numpy as np
import pytest

from benchmark import cell as cells
from benchmark import timing
from benchmark.roofline import atrous, peaks
from benchmark.trace import WINDOW_SPAN, Trace


def test_roofline_hand_count_at_4x4():
    nbytes, ops = atrous.sweep_work(4, 4, radius=2, iterations=5)
    # 8 planes read and 8 written, 4 bytes each, 16 pixels
    assert nbytes == 16 * 4 * 16
    # 32 operations a tap, 25 taps, 5 levels, 16 pixels
    assert ops == 32 * 25 * 5 * 16
    assert atrous.OPS_PER_TAP == 32
    assert peaks.least_seconds(nbytes, ops) == max(nbytes / 3.35e12,
                                                   ops / 67e12)


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(3).gamma(2.0, 3.0, 257))
    assert math.isclose(timing.percentile(xs, q), np.percentile(xs, q),
                        rel_tol=1e-12)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert timing.union_length(iv, 0, 10) == 3 + 1 + 1
    assert timing.union_length(iv, 1.5, 5.5) == 1.5 + 0.5
    assert timing.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert timing.gaps([], 0, 1) == [(0, 1)]
    lo, hi = 0.0, 10.0
    assert math.isclose(timing.union_length(iv, lo, hi)
                        + sum(e - s for s, e in timing.gaps(iv, lo, hi)),
                        hi - lo)


def test_closed_loop_counts_and_keeps_units_in_flight():
    done = []
    wall, n, steps = timing.closed_loop(done.append, 0.05, 2, None)
    assert n == len(done) >= 2 and done == list(range(n))
    assert len(steps) == n - 1 and all(s >= 0 for s in steps)
    assert wall >= 0.05


def synthetic_trace(units=4):
    """A window of 1000 µs: renderer 0-100 and 500-600, atrous 100-300,
    glue 300-350 and 320-330 (overlapping), an idle gap 350-500 while the
    host waits, 600-1000 idle in python."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW_SPAN,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
           "ts": 340, "dur": 170}]
    for name, s, e in [
            ("void march_kernel<1, 3, 5>(float const*)", 0, 100),
            ("void level_kernel<2, true, false>(int)", 100, 300),
            ("void at::native::vectorized_elementwise_kernel<4>()", 300, 350),
            ("Memset (Device)", 320, 330),
            ("void shade_kernel<1, 3, 5>(float const*)", 500, 600)]:
        ev.append({"ph": "X", "cat": "gpu_memset" if "Memset" in name
                   else "kernel", "name": name, "ts": s, "dur": e - s})
    cfg = {"width": 3840, "height": 2160,
           "svgf": {"radius": 2, "iterations": 5}}
    return Trace(ev, units, cfg, cells.kernel_layers())


def test_readers_on_a_synthetic_trace():
    tr = synthetic_trace()
    assert math.isclose(tr.window_s, 1e-3)
    assert math.isclose(tr.busy_s, 450e-6)

    def read(name):
        return cells.metric_reader(name)(tr)

    assert math.isclose(read("device_idle_pct.serve"), 55.0)
    assert math.isclose(read("render_ms.serve"), 0.2 / 4)
    assert math.isclose(read("atrous_ms.serve"), 0.2 / 4)
    assert math.isclose(read("glue_ms.train"), 0.06 / 4)
    assert read("temporal_ms.serve") is None
    nbytes, ops = atrous.sweep_work(3840, 2160, 2, 5)
    least_ms = peaks.least_seconds(nbytes, ops) * 1e3
    assert math.isclose(read("atrous_roofline.serve"),
                        100 * least_ms / (0.2 / 4))
    b = tr.breakdown()
    assert b["device_ops"][0] == ["void level_kernel<2, true, false>(int)",
                                  200e-6]
    idle = dict(b["idle_gaps"])
    assert math.isclose(idle["cudaEventSynchronize"], 150e-6)
    assert math.isclose(idle["(python between operations)"], 400e-6)
