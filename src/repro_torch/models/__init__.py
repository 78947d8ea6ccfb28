"""The LM of the port (every family: dense, ssm, hybrid, moe, vlm and
audio), mirroring ``repro.models``."""
from repro_torch.models.lm import (
    DecodeState,
    build_model,
    forward_decode,
    forward_prefill,
    forward_train,
    init_decode_state,
    init_params,
    load_reference_opt_state,
    load_reference_params,
    score_last,
)

__all__ = [
    "DecodeState",
    "build_model",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_decode_state",
    "init_params",
    "load_reference_opt_state",
    "load_reference_params",
    "score_last",
]
