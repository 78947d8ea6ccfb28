"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified].

Fitting 256×16 GB (single pod): params/optimizer state fully sharded over the
whole mesh, optimizer moments in bf16 (a framework lever, DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=32768,
)

REDUCED = reduce_config(CONFIG)
