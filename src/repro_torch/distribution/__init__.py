"""The port's train, prefill and decode steps, on one device or an LM mesh,
and the sharding rules, their DTensor placements and the fleet mesh
(``distribution.sharding``)."""
from repro_torch.distribution.steps import (
    StepBundle,
    make_decode_step,
    make_prefill_step,
    make_step_for_cell,
    make_train_step,
)

__all__ = [
    "StepBundle",
    "make_decode_step",
    "make_prefill_step",
    "make_step_for_cell",
    "make_train_step",
]
