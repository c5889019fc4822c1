"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``).

``build_params`` walks the reference's parameter structure with a
``Builder``: the layer weights stacked ``(G, P, ...)`` — ``G`` groups of
``P`` sublayers (P = 2 for gemma2's local/global alternation, else 1) —
beside ``embed``, ``final_norm`` and an untied ``head``.  ``DecoderLM``
holds the same tensors as an ``nn.Module``: layer ``l = g * P + p`` is the
slice ``[g, p]`` of every stacked weight, in the reference's layouts
(``wq`` (D, H, hd), ``wo`` (H, hd, D), ``w_gate`` (D, F), ...), so carrying
weights across is slicing.  The layers run in a Python loop; caches are
updated in place.

A residual sum is rounded to bf16 for the residual stream, but the norm
that reads it next takes the fp32 sum: the reference's compiled layer
group drops the bf16 rounding between an add and the fp32 upcast of
``rms_norm`` (XLA's excess precision), so the port computes the same
function.  Across the reference's scan carry (a group of ``P`` sublayers)
the stream is bf16.

``num_experts > 0`` (the MoE family) is ROADMAP A, slice 16c.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from . import attention as attn
from .common import (Builder, ModelConfig, ShardingRules, embed_tokens,
                     glu_mlp, lm_head, plain_mlp, rms_norm, rope_angles)

_MOE_LATER = ("the MoE family (num_experts > 0, repro.models.moe) is "
              "ROADMAP A, slice 16c; it is not ported to repro_torch yet")


def _group_shape(cfg: ModelConfig):
    P = max(cfg.local_global_period, 1)
    if cfg.num_layers % P:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple "
                         f"of local_global_period={P}")
    return cfg.num_layers // P, P


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    """The reference's parameter tree, built by ``b``, in its order."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_LATER)
    G, P = _group_shape(cfg)
    D, H, KV, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    lp: Dict[str, Any] = {
        "ln1": b("ln1", (G, P, D), (None, None, None), init="zeros"),
        "wq": b("wq", (G, P, D, H, hd), (None, None, "fsdp", "heads", "head_dim")),
        "wk": b("wk", (G, P, D, KV, hd), (None, None, "fsdp", "kv_heads", "head_dim")),
        "wv": b("wv", (G, P, D, KV, hd), (None, None, "fsdp", "kv_heads", "head_dim")),
        "wo": b("wo", (G, P, H, hd, D), (None, None, "heads", "head_dim", "fsdp")),
        "ln2": b("ln2", (G, P, D), (None, None, None), init="zeros"),
    }
    if cfg.mlp_type == "plain":
        lp.update({
            "w_up": b("w_up", (G, P, D, F), (None, None, "fsdp", "d_ff")),
            "w_down": b("w_down", (G, P, F, D), (None, None, "d_ff", "fsdp")),
        })
    else:
        lp.update({
            "w_gate": b("w_gate", (G, P, D, F), (None, None, "fsdp", "d_ff")),
            "w_up": b("w_up", (G, P, D, F), (None, None, "fsdp", "d_ff")),
            "w_down": b("w_down", (G, P, F, D), (None, None, "d_ff", "fsdp")),
        })
    params = {
        "embed": b("embed", (V, D), ("vocab", "fsdp")),
        "final_norm": b("final_norm", (D,), (None,), init="zeros"),
        "layers": lp,
    }
    if not cfg.tie_embeddings:
        params["head"] = b("head", (D, V), ("fsdp", "vocab"))
    return params


def _layer_window(cfg: ModelConfig, p: int) -> int:
    if cfg.local_global_period > 1:
        # gemma2 convention: sublayer 0 local (windowed), sublayer 1 global
        return cfg.window if p == 0 else 0
    return cfg.window


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # serving holds the weights fixed; the training slice turns grads on
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One sublayer's weights (the reference's ``[g, p]`` slice) and its
    attention window."""

    def __init__(self, weights: Dict[str, torch.Tensor], window: int):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, _frozen(w))
        self.window = int(window)


class DecoderLM(nn.Module):
    """The dense decoder LM: ``embed`` (V, D), ``final_norm`` (D,),
    ``head`` (D, V) when untied, and ``layers``, an ``nn.ModuleList`` of
    ``DecoderLayer``s."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(_MOE_LATER)
        self.cfg = cfg
        G, P = _group_shape(cfg)
        self.embed = _frozen(tree["embed"])
        self.final_norm = _frozen(tree["final_norm"])
        self.head = _frozen(tree["head"]) if "head" in tree else None
        lp = tree["layers"]
        self.layers = nn.ModuleList(
            DecoderLayer({name: w[g, p] for name, w in lp.items()},
                         _layer_window(cfg, p))
            for g in range(G) for p in range(P))

    def to_tree(self) -> Dict[str, Any]:
        """The weights in the reference's tree layout (layers restacked)."""
        G, P = _group_shape(self.cfg)
        names = [n for n, _ in self.layers[0].named_parameters()]
        lp = {n: torch.stack([getattr(l, n) for l in self.layers])
              .reshape(G, P, *getattr(self.layers[0], n).shape)
              for n in names}
        tree = {"embed": self.embed.data, "final_norm": self.final_norm.data,
                "layers": {n: t.data for n, t in lp.items()}}
        if self.head is not None:
            tree["head"] = self.head.data
        return tree

    def forward(self, tokens, positions, cache=None):
        return forward(self, self.cfg, None, tokens, positions, cache=cache)


def _sublayer(x, x_hi, layer: DecoderLayer, cfg: ModelConfig,
              rules: ShardingRules, q_pos, cache_row, layer_window: int,
              angles=None):
    """One transformer sublayer; returns the bf16 stream and its fp32 sum
    before the rounding.  ``x_hi``: the fp32 sum behind ``x`` when the
    previous sublayer is in the same group, else None.  cache_row: None
    (no cache) or the (k (B, C, KV, hd), v, slot_pos (C,)) views of this
    layer's cache rows, written in place."""
    dt = x.dtype
    h = rms_norm(x if x_hi is None else x_hi, layer.ln1).to(dt)
    q, k, v = attn.qkv_project(h, layer.wq, layer.wk, layer.wv, cfg, rules,
                               q_pos, angles)
    if cache_row is None:
        ctx = attn.attend(q, k, v, q_pos, q_pos, cfg, rules,
                          window=layer_window)
    else:
        ck, cv, cpos = attn.cache_write(*cache_row, k, v, q_pos,
                                        layer_window)
        if q_pos.shape[0] > 1:
            # prefill-from-scratch: attend over the fresh K/V (exact even
            # when a rolling window buffer retains fewer than S entries)
            ctx = attn.attend(q, k, v, q_pos, q_pos, cfg, rules,
                              window=layer_window)
        else:
            ctx = attn.attend(q, ck, cv, q_pos, cpos, cfg, rules,
                              window=layer_window)
    s1 = x.float() + attn.out_project(ctx, layer.wo, rules).float()
    x = s1.to(dt)
    h2 = rms_norm(s1, layer.ln2).to(dt)
    if cfg.mlp_type == "plain":
        y = plain_mlp(h2, layer.w_up, layer.w_down, cfg.mlp_act, rules)
    else:
        y = glu_mlp(h2, layer.w_gate, layer.w_up, layer.w_down, cfg.mlp_act,
                    rules)
    s2 = x.float() + y.float()
    return s2.to(dt), s2


def _cache_row(cache, l: int, P: int, window: int):
    """Layer ``l``'s rows of ``cache``: a ``KVCache`` over every layer, or
    gemma2's ``{"local": ..., "global": ...}`` split, one row a group
    each."""
    if isinstance(cache, dict):
        c, i = cache["local" if window > 0 else "global"], l // P
    else:
        c, i = cache, l
    return c.k[i], c.v[i], c.slot_pos[i]


@torch.no_grad()
def forward(params: DecoderLM, cfg: ModelConfig, rules: ShardingRules,
            tokens, positions, cache=None):
    """tokens (B, S) int; positions (S,) absolute.  Returns (logits (B, S, V) fp32, cache | None); a cache is
    updated in place and returned."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_LATER)
    _, P = _group_shape(cfg)
    x = embed_tokens(tokens, params.embed, rules, scale=cfg.embed_scale,
                     dtype=cfg.dtype)
    x_hi = None
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for l, layer in enumerate(params.layers):
        row = None if cache is None else _cache_row(cache, l, P,
                                                    layer.window)
        x, x_hi = _sublayer(x, x_hi if l % P else None, layer, cfg, rules,
                            positions, row, layer.window, angles)
    x = rms_norm(x, params.final_norm)
    head = params.embed.T if cfg.tie_embeddings else params.head
    return lm_head(x, head, cfg, rules), cache


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def prefill(params: DecoderLM, cfg: ModelConfig, rules: ShardingRules,
            tokens, cache):
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    return forward(params, cfg, rules, tokens, positions, cache=cache)


def decode_step(params: DecoderLM, cfg: ModelConfig, rules: ShardingRules,
                tokens, pos, cache):
    """tokens (B, 1); pos — the absolute position of the new token (an int,
    or a tensor on the tokens' device, which keeps the step free of host
    copies)."""
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=tokens.device).reshape(1)
    return forward(params, cfg, rules, tokens, positions, cache=cache)
