"""Device time an update of the window step inside the replayed body:
the rate grids, masks, tick draws, summary, emission and reward, less the
fault grid's rows and the window kernel's own (``harness/spans.py``)."""
from tunebench.harness.spans import part_ms_per_update


def read(trace):
    return part_ms_per_update(trace, "window_step")
