"""gemma2-27b [arXiv:2408.00118] — 46L d4608 32H GQA(kv=16), alternating
local(4096)/global attention, attn+final logit softcaps, GeGLU.
Runs long_500k: half the layers are 4096-window local; global layers hold a
mesh-sharded KV (linear per decode step)."""
from ..models.common import ModelConfig

ARCH = "gemma2-27b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense", num_layers=46, d_model=4608,
        num_heads=32, num_kv_heads=16, head_dim=128, d_ff=36864,
        vocab_size=256000, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, window=4096, local_global_period=2,
        attn_softcap=50.0, logit_softcap=30.0, attn_shard="heads",
        supports_long_context=True, remat="full")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, window=16, local_global_period=2,
        attn_softcap=50.0, logit_softcap=30.0, remat="none",
        supports_long_context=True)
