"""The LM of the port (dense family so far), mirroring ``repro.models``."""
from repro_torch.models.lm import (
    DecodeState,
    forward_prefill,
    init_decode_state,
    init_params,
    load_reference_params,
)

__all__ = [
    "DecodeState",
    "forward_prefill",
    "init_decode_state",
    "init_params",
    "load_reference_params",
]
