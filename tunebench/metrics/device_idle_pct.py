"""Share of the traced window in which nothing ran on the device: one minus
the union of every kernel's, copy's and set's interval over the window, both
from the same profiled chunks (the profiler slows each graph launch, so this
is the traced window's share; the run logs the slowdown beside it)."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
