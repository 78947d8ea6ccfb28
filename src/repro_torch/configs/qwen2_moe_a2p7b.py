"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. Shared-expert hidden = 4×1408 = 5632."""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,          # shared-expert hidden (4 shared experts x 1408)
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
)

REDUCED = reduce_config(CONFIG)
