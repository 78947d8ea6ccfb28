"""Device time an update of the fault grid inside the replayed body
(``fault_effect_grid`` and its rate shock, every window;
``harness/spans.py``)."""
from tunebench.harness.spans import part_ms_per_update


def read(trace):
    return part_ms_per_update(trace, "fault_grid")
