"""Host time a chunk of the episode batch's tick budget: the program's
``rt.epoch.tick_budget`` span around ``_tick_budget``, which packs the
fleet's configs to read their tick lengths where ``batch_interval_s`` is
not tuned. None where the program has no such span."""
from tunebench.harness.spans import host_ms


def read(trace):
    ms = host_ms(trace, "rt.epoch.tick_budget".__eq__)
    return None if ms is None else ms / trace.chunks
