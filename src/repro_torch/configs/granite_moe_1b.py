"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base] —
24L d1024 16H GQA(kv=8), MoE 32 experts top-8, expert d_ff=512.
vocab 49155 padded to 49280.  kv=8 < 16 -> head_dim attention sharding."""
from ..models.common import ModelConfig

ARCH = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="moe", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
        vocab_size=49280, num_experts=32, num_experts_per_tok=8,
        tie_embeddings=True, attn_shard="pad_heads", attn_pad_to=16)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
        vocab_size=512, num_experts=4, num_experts_per_tok=2,
        tie_embeddings=True, attn_shard="head_dim", remat="none",
        capacity_factor=4.0)
