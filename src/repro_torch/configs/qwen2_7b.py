"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671; hf]. 28 heads are padded to 32 for
TP=16 divisibility by the sharding layer (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = reduce_config(CONFIG)
