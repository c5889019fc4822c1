"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — 35L d7168 56H GQA(kv=8),
MoE 128 experts top-2 PLUS a dense residual MLP in parallel (dense-MoE
hybrid).  56 heads / kv=8 don't divide 16-way TP -> head_dim sharding.
Trains with Adafactor (fp32 params, factored second moment) — Adam's fp32
m/v would not fit 16 GB/chip at this scale (DESIGN.md §4)."""
from ..models.common import ModelConfig

ARCH = "arctic-480b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="moe", num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=4864,
        vocab_size=32000, num_experts=128, num_experts_per_tok=2,
        moe_dense_residual=True, moe_dense_ff=4864,
        tie_embeddings=False, attn_shard="pad_heads", attn_pad_to=64,
        remat="full")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="moe", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=512, num_experts=8, num_experts_per_tok=2,
        moe_dense_residual=True, moe_dense_ff=64,
        tie_embeddings=False, attn_shard="head_dim", remat="none",
        capacity_factor=4.0)
