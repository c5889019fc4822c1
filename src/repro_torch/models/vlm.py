"""phi-3-vision (port of ``repro.models.vlm``): the phi3-mini transformer
backbone and a stubbed CLIP frontend, as in the reference: the caller
feeds precomputed patch embeddings (B, P, ``D_VISION``), and only their
projection into the model's width, ``patch_proj`` (``D_VISION``, D), is a
parameter.

The projected patches come before the tokens in one stream, which starts
the transformer through its ``inputs_embeds``; positions count over the
whole stream, so the first decoded token of a prompt of S tokens sits at
``P + S``.  Decode is the transformer's: the patches are in the KV cache.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import transformer
from .common import Builder, ModelConfig, ShardingRules, embed_tokens

D_VISION = 1024  # CLIP ViT-L/14 output width


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    params = transformer.build_params(cfg, b)
    params["patch_proj"] = b("patch_proj", (D_VISION, cfg.d_model),
                             (None, "fsdp"))
    return params


def _embed(params, cfg: ModelConfig, rules: ShardingRules, tokens,
           patch_embeds):
    """(B, P + S, D): the projected patches, then the tokens' rows (the
    tokens' alone without ``patch_embeds``)."""
    tok = embed_tokens(tokens, params["embed"], rules,
                       scale=cfg.embed_scale, dtype=cfg.dtype)
    if patch_embeds is None:
        return tok
    pe = patch_embeds.to(cfg.dtype) @ params["patch_proj"]
    return torch.cat([pe, tok], dim=1)


def _positions(x):
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def forward_train(params, cfg: ModelConfig, rules: ShardingRules, tokens,
                  patch_embeds):
    """Logits (B, P + S, V) fp32 of the patches and tokens, no cache."""
    x = _embed(params, cfg, rules, tokens, patch_embeds)
    return transformer.forward(params, cfg, rules, tokens, _positions(x),
                               inputs_embeds=x)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, rules: ShardingRules, tokens,
            patch_embeds, cache):
    """The patches and the prompt written into ``cache`` from position 0."""
    x = _embed(params, cfg, rules, tokens, patch_embeds)
    return transformer.forward(params, cfg, rules, tokens, _positions(x),
                               cache=cache, inputs_embeds=x)


def decode_step(params, cfg: ModelConfig, rules: ShardingRules, tokens, pos,
                cache):
    return transformer.decode_step(params, cfg, rules, tokens, pos, cache)
