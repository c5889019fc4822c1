"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
backbone (32L d3072 32H kv=32) + CLIP frontend STUB: input_specs() feeds
precomputed 576x1024 patch embeddings through a learned projection."""
from ..models.common import ModelConfig

ARCH = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="vlm", num_layers=32, d_model=3072,
        num_heads=32, num_kv_heads=32, head_dim=96, d_ff=8192,
        vocab_size=32064, tie_embeddings=False, num_patches=576,
        rope_theta=10000.0, attn_shard="heads")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=512, tie_embeddings=False, num_patches=8, remat="none")
