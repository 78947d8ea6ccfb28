"""rwkv6-7b (Finch) [ssm] — 32L d_model=4096 attn-free d_ff=14336 vocab=65536.

Data-dependent decay (wkv6 recurrence). [arXiv:2404.05892; hf].
head_dim=64 → 64 wkv heads. Channel-mix hidden = d_ff.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,        # wkv heads (d_model / ssm_head_dim)
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_state=64,        # per-head state is (head_dim x head_dim)
    ssm_head_dim=64,
)

REDUCED = reduce_config(CONFIG, num_heads=4, num_kv_heads=4, ssm_head_dim=32)
