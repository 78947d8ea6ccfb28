"""The port's train, prefill and decode steps (one device; LM meshes wait
for ROADMAP queue 1, item 7.2) and the sharding rules with the fleet mesh
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
