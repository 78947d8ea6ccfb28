"""Device time an update of the safety shield inside the replayed body:
its mask, clamp, fallback and ``shield_update`` at every step
(``harness/spans.py``)."""
from tunebench.harness.spans import part_ms_per_update


def read(trace):
    return part_ms_per_update(trace, "shield")
