"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch. [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
)

REDUCED = reduce_config(CONFIG)
