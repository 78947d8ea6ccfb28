"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]. Also the framework's
real-CPU reference model (LocalEngine). 9 heads pad to 16 for TP=16.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)

REDUCED = reduce_config(CONFIG)
