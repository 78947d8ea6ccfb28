"""Device time an update of the policy update inside the replayed body
(``ReinforceAgent._update_in_place``: the REINFORCE gradient and
rmsprop; ``harness/spans.py``)."""
from tunebench.harness.spans import part_ms_per_update


def read(trace):
    return part_ms_per_update(trace, "policy_update")
