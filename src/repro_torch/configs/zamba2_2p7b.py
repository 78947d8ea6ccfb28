"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]. The shared transformer block (full attention + MLP,
one weight set reused) is applied every ``hybrid_period`` Mamba2 layers —
Zamba2's per-invocation LoRA deltas are omitted (noted in DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_period=6,
)

REDUCED = reduce_config(CONFIG)
