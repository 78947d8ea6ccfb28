"""The LM of the port (dense and ssm families so far), mirroring
``repro.models``."""
from repro_torch.models.lm import (
    DecodeState,
    forward_prefill,
    forward_train,
    init_decode_state,
    init_params,
    load_reference_opt_state,
    load_reference_params,
)

__all__ = [
    "DecodeState",
    "forward_prefill",
    "forward_train",
    "init_decode_state",
    "init_params",
    "load_reference_opt_state",
    "load_reference_params",
]
