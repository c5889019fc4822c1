"""gemma-2b [arXiv:2403.08295] — 18L d2048, MQA (kv=1), GeGLU, head_dim=256.
8 query heads < 16-way TP, so attention shards over head_dim."""
from ..models.common import ModelConfig

ARCH = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=256000, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, attn_shard="pad_heads", attn_pad_to=16)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=512, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, attn_shard="head_dim", remat="none")
