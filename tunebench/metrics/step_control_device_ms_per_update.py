"""Device time an update of the step's control inside the replayed body:
encode, act, lever apply with the deploy ring, loading and stabilisation,
less the shield's rows (``harness/spans.py``)."""
from tunebench.harness.spans import part_ms_per_update


def read(trace):
    return part_ms_per_update(trace, "step_control")
