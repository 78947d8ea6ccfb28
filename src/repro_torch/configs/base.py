"""Config system: model configs, input shapes, engine/tuner configs, registry.

Every assigned architecture gets one ``src/repro/configs/<id>.py`` exporting a
``CONFIG`` (full size, from the public literature) and a ``REDUCED`` variant for
CPU smoke tests. ``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Sequence

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden; d_ff used for shared/dense part
    moe_capacity_factor: float = 1.25  # GShard capacity; tuner lever
    # dispatch group length: the GShard one-hot dispatch/combine einsums cost
    # O(S·E·C·d) with C ∝ S/E — quadratic in sequence per group. Splitting the
    # sequence into groups of this size makes C ∝ group_size (16x less
    # dispatch compute at 32k prefill). 0 = one group (paper-faithful GShard).
    moe_group_size: int = 0
    # --- SSM (mamba2 / rwkv6) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # --- hybrid (zamba2): shared attention block every `hybrid_period` layers
    hybrid_period: int = 0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend: #frames fed to the encoder
    # --- vlm ---
    vision_tokens: int = 0  # stub frontend: #patch embeddings prepended
    # --- norm/act ---
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    # --- sharding-induced padding (set by the distribution layer) ---
    vocab_true: int = 0  # 0 -> vocab_size (no padding); else logical vocab
    # --- runtime knobs (not architecture) ---
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"  # chunked | naive | pallas
    attn_chunk: int = 1024
    wkv_chunk: int = 32         # rwkv6 recurrence chunk (perf lever)
    scan_layers: bool = True
    remat: str = "block"  # none | block | full

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is admissible (SSM/hybrid/linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (matches init, used for 6ND roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        dense_mlp = 3 * d * self.d_ff  # gate/up/down (silu-glu)
        norms = 2 * d

        def block_dense():
            return attn + dense_mlp + norms

        def block_moe():
            e = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * (self.moe_d_ff * 4)
            router = d * self.num_experts
            return attn + e + shared + router + norms

        def block_mamba2():
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            inproj = d * (2 * d_in + 2 * self.ssm_state + nh)
            conv = 4 * (d_in + 2 * self.ssm_state)
            out = d_in * d + d_in  # out proj + gate norm
            return inproj + conv + out + nh * 2 + d  # A, D per head + norm

        def block_rwkv6():
            tm = d * d * 4 + d * 64 * 2 + 64 * d * 6 + d * 6  # r,k,v,g,w(+lora) + mixes
            cm = 2 * d * int(3.5 * d) + d * int(3.5 * d)
            return tm + cm + norms

        if self.family in ("dense", "vlm"):
            total = self.num_layers * block_dense()
        elif self.family == "moe":
            total = self.num_layers * block_moe()
        elif self.family == "ssm":
            total = self.num_layers * block_rwkv6()
        elif self.family == "hybrid":
            n_shared_calls = self.num_layers // max(self.hybrid_period, 1)
            total = self.num_layers * block_mamba2() + block_dense()  # shared blk once
            total += n_shared_calls * 0  # weights shared; LoRA omitted
        elif self.family == "audio":
            total = (self.num_layers + self.encoder_layers) * block_dense()
            total += self.num_layers * (attn + norms // 2)  # cross-attention
        else:
            raise ValueError(self.family)

        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return int(total + emb + head + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        inactive = (
            self.num_layers
            * (self.num_experts - self.moe_top_k)
            * 3
            * self.d_model
            * self.moe_d_ff
        )
        return int(full - inactive)


# ---------------------------------------------------------------------------
# Input shapes (assigned set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS: Sequence[str] = (
    "zamba2_2p7b",
    "qwen2_7b",
    "deepseek_coder_33b",
    "stablelm_12b",
    "smollm_135m",
    "internvl2_26b",
    "qwen2_moe_a2p7b",
    "grok1_314b",
    "whisper_large_v3",
    "rwkv6_7b",
)

_ALIAS = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-7b": "qwen2_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "stablelm-12b": "stablelm_12b",
    "smollm-135m": "smollm_135m",
    "internvl2-26b": "internvl2_26b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "grok-1-314b": "grok1_314b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-7b": "rwkv6_7b",
}


def canonical(name: str) -> str:
    return _ALIAS.get(name, name.replace("-", "_").replace(".", "p"))


def get(name: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get(a, reduced) for a in ARCH_IDS}


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving shrink used by every REDUCED config."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_chunk=64,
        scan_layers=False,
        remat="none",
        dtype="float32",
    )
    if cfg.num_experts:
        # high capacity factor -> no token drops at tiny scale, so the
        # decode-vs-prefill consistency smoke test is exact.
        base.update(num_experts=4, moe_top_k=2, moe_d_ff=64,
                    num_shared_experts=min(cfg.num_shared_experts, 1),
                    moe_capacity_factor=8.0)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=32)
    if cfg.hybrid_period:
        base.update(hybrid_period=2)
    if cfg.encoder_layers:
        base.update(encoder_layers=2, encoder_seq=16)
    if cfg.vision_tokens:
        base.update(vision_tokens=8)
    base.update(overrides)
    return replace(cfg, **base)
