"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. InternViT frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (vision_tokens × d_model) that the backbone
prepends to the text embeddings. [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    vision_tokens=256,
)

REDUCED = reduce_config(CONFIG)
