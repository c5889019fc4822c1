"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].
24L d_model=768, attn-free, ssm_state=128.  vocab 50280 padded to 50432 for
16-way TP divisibility (DESIGN.md §7)."""
from ..models.common import ModelConfig

ARCH = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="ssm", num_layers=24, d_model=768,
        num_heads=1, num_kv_heads=1, head_dim=64, d_ff=0,
        vocab_size=50432, ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
        ssm_conv=4, ssm_expand=2, tie_embeddings=True,
        supports_long_context=True)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="ssm", num_layers=2, d_model=64,
        num_heads=1, num_kv_heads=1, head_dim=16, d_ff=0,
        vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
        ssm_conv=4, ssm_expand=2, tie_embeddings=True, remat="none",
        supports_long_context=True)
