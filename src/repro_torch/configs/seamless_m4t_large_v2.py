"""seamless-m4t-large-v2 [arXiv:2308.11596] — enc-dec, 24 encoder + 24
decoder layers, d1024 16H kv=16, d_ff 8192.  Speech frontend STUB:
input_specs() feeds precomputed frame embeddings (B, T, d_model).
vocab 256206 padded to 256256."""
from ..models.common import ModelConfig

ARCH = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="encdec", num_layers=24, num_decoder_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=8192, vocab_size=256256, tie_embeddings=True,
        attn_shard="heads")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="encdec", num_layers=2,
        num_decoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, tie_embeddings=True,
        remat="none")
