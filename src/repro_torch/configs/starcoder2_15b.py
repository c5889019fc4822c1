"""starcoder2-15b [arXiv:2402.19173] — 40L d6144 48H GQA(kv=4), RoPE,
plain (non-GLU) MLP with GELU, 4x widening.  kv=4 < 16-way TP -> head_dim
attention sharding."""
from ..models.common import ModelConfig

ARCH = "starcoder2-15b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense", num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=4, head_dim=128, d_ff=24576,
        vocab_size=49152, mlp_act="gelu", mlp_type="plain",
        tie_embeddings=False, rope_theta=100000.0, attn_shard="pad_heads",
        attn_pad_to=48, remat="full")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="dense", num_layers=2, d_model=96,
        num_heads=6, num_kv_heads=2, head_dim=16, d_ff=384,
        vocab_size=512, mlp_act="gelu", mlp_type="plain",
        tie_embeddings=False, attn_shard="head_dim", remat="none")
