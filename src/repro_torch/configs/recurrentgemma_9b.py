"""recurrentgemma-9b [arXiv:2402.19427] — Griffin: RG-LRU recurrent blocks +
local MQA attention (window 2048) in 1:2 pattern, 38L d4096.
Bounded state -> runs long_500k."""
from ..models.common import ModelConfig

ARCH = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="hybrid", num_layers=38, d_model=4096,
        num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
        vocab_size=256000, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, window=2048, rnn_width=4096, rnn_block_period=3,
        attn_shard="pad_heads", attn_pad_to=16, supports_long_context=True,
        remat="full")


def reduced() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-reduced", family="hybrid", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=512, mlp_act="gelu", tie_embeddings=True,
        embed_scale=True, window=16, rnn_width=64, rnn_block_period=3,
        attn_shard="head_dim", remat="none", supports_long_context=True)
