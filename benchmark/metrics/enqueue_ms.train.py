"""Host ms a step inside the span `rdt.step` (`train_step`): the host's
time to enqueue a step, waits for the card included (host_syncs.train),
in the traced window (the profiler adds its own cost to every operation).
Moves step_ms."""

from benchmark.spans import span_ms


def read(trace):
    return span_ms(trace, "rdt.step", "host_ms")
