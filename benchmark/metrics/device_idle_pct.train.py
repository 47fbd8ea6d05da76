"""The share of the traced window, in %, in which no operation ran on the
device (the union of the operations' intervals, not their sum).  Moves
step_ms: a step the host holds back shows as idle time."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
