"""internlm2-1.8b [arXiv:2403.17297] — 24L d2048 16H GQA(kv=8), SwiGLU.
kv=8 < 16-way TP -> head_dim attention sharding."""
from ..models.common import ModelConfig

ARCH = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=92544, mlp_act="silu", tie_embeddings=False,
        rope_theta=1000000.0, attn_shard="pad_heads", attn_pad_to=16)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, tie_embeddings=False, attn_shard="head_dim",
        remat="none")
