"""whisper-large-v3 [audio] — enc-dec, 32L d_model=1280 20H d_ff=5120
vocab=51866. [arXiv:2212.04356; unverified].

The conv/mel frontend is a STUB: ``input_specs()`` ships precomputed frame
embeddings (encoder_seq × d_model). Decoder has self + cross attention;
20 heads pad to 32 for TP=16. Non-causal encoder, causal decoder.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    rope_theta=0.0,         # whisper uses absolute positions, not RoPE
)

REDUCED = reduce_config(CONFIG)
