"""Decoder-only transformer LM, dense and MoE families (port of
``repro.models.transformer``).

``build_params`` walks the reference's parameter structure with a
``Builder``: the layer weights stacked ``(G, P, ...)`` — ``G`` groups of
``P`` sublayers (P = 2 for gemma2's local/global alternation, else 1) —
beside ``embed``, ``final_norm`` and an untied ``head``, in the
reference's layouts (``wq`` (D, H, hd), ``wo`` (H, hd, D), ``w_gate``
(D, F), ...).  That tree of tensors is the model, for serving and
training alike.  ``forward`` splits each stacked leaf into its layers
with one ``unbind``, whose backward stacks the layers' gradients into one
``(G, P, ...)`` gradient (indexing a layer out of the leaf would make a
full-size zero gradient a layer).  The layers run in a Python loop, a
group of ``P`` under ``cfg.remat``'s checkpointing when gradients are on;
caches are updated in place.

A residual sum is rounded to bf16 for the residual stream, but the norm
that reads it next takes the fp32 sum: the reference's compiled layer
group drops the bf16 rounding between an add and the fp32 upcast of
``rms_norm`` (XLA's excess precision), so the port computes the same
function.  Across the reference's scan carry (a group of ``P`` sublayers)
the stream is bf16.

With ``num_experts > 0`` (the MoE family) a layer's MLP is
``moe.moe_mlp`` over its fp32 ``router`` and stacked experts ``e_gate``,
``e_up`` (E, D, F) and ``e_down`` (E, F, D); arctic's
``moe_dense_residual`` adds a dense GLU (``r_gate``, ``r_up``,
``r_down``) to it in bf16.  That output joins the fp32 residual sum as the
dense MLP's does (the reference's compiled layer rounds the MoE output
and the residual sum as it rounds the dense one's).
"""
from __future__ import annotations

import types
from typing import Any, Dict

import torch

from . import attention as attn
from .common import (Builder, ModelConfig, ShardingRules, embed_tokens,
                     glu_mlp, lm_head, maybe_remat, plain_mlp, rms_norm,
                     rope_angles, wide)
from .moe import moe_mlp


def _group_shape(cfg: ModelConfig):
    P = max(cfg.local_global_period, 1)
    if cfg.num_layers % P:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple "
                         f"of local_global_period={P}")
    return cfg.num_layers // P, P


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    """The reference's parameter tree, built by ``b``, in its order."""
    G, P = _group_shape(cfg)
    D, H, KV, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    E = cfg.num_experts
    lp: Dict[str, Any] = {
        "ln1": b("ln1", (G, P, D), (None, None, None), init="zeros"),
        "wq": b("wq", (G, P, D, H, hd), (None, None, "fsdp", "heads", "head_dim")),
        "wk": b("wk", (G, P, D, KV, hd), (None, None, "fsdp", "kv_heads", "head_dim")),
        "wv": b("wv", (G, P, D, KV, hd), (None, None, "fsdp", "kv_heads", "head_dim")),
        "wo": b("wo", (G, P, H, hd, D), (None, None, "heads", "head_dim", "fsdp")),
        "ln2": b("ln2", (G, P, D), (None, None, None), init="zeros"),
    }
    if E > 0:
        lp.update({
            "router": b("router", (G, P, D, E), (None, None, "fsdp", None),
                        dtype=torch.float32),
            "e_gate": b("e_gate", (G, P, E, D, F), (None, None, "experts", "fsdp", None)),
            "e_up": b("e_up", (G, P, E, D, F), (None, None, "experts", "fsdp", None)),
            "e_down": b("e_down", (G, P, E, F, D), (None, None, "experts", None, "fsdp")),
        })
        if cfg.moe_dense_residual:
            Fd = cfg.moe_dense_ff or F
            lp.update({
                "r_gate": b("r_gate", (G, P, D, Fd), (None, None, "fsdp", "d_ff")),
                "r_up": b("r_up", (G, P, D, Fd), (None, None, "fsdp", "d_ff")),
                "r_down": b("r_down", (G, P, Fd, D), (None, None, "d_ff", "fsdp")),
            })
    elif cfg.mlp_type == "plain":
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


def _sublayer(x, x_hi, layer, cfg: ModelConfig,
              rules: ShardingRules, q_pos, cache_row, layer_window: int,
              angles=None):
    """One transformer sublayer (``layer``: its weights by name and its
    attention window); returns the bf16 stream and its fp32 sum before the
    rounding.  ``x_hi``: the fp32 sum behind ``x`` when the
    previous sublayer is in the same group, else None.  cache_row: None
    (no cache) or the (k (B, C, KV, hd), v, slot_pos (C,)) views of this
    layer's cache rows, written in place (this rank's shard of them under
    the sharded serve steps: ``attention.cache_shard``)."""
    dt = x.dtype
    h = rms_norm(x if x_hi is None else x_hi, layer.ln1).to(dt)
    q, k, v = attn.qkv_project(h, layer.wq, layer.wk, layer.wv, cfg, rules,
                               q_pos, angles)
    if cache_row is None:
        ctx = attn.attend(q, k, v, q_pos, q_pos, cfg, rules,
                          window=layer_window)
    else:
        shard = attn.cache_shard()
        ck, cv, cpos = attn.cache_write(*cache_row, k, v, q_pos,
                                        layer_window, shard)
        if q_pos.shape[0] > 1:
            # prefill-from-scratch: attend over the fresh K/V (exact even
            # when a rolling window buffer retains fewer than S entries)
            ctx = attn.attend(q, k, v, q_pos, q_pos, cfg, rules,
                              window=layer_window)
        else:
            ctx = attn.attend(q, ck, cv, q_pos, cpos, cfg, rules,
                              window=layer_window, shard=shard)
    s1 = wide(x) + wide(attn.out_project(ctx, layer.wo, rules))
    x = s1.to(dt)
    h2 = rms_norm(s1, layer.ln2).to(dt)
    if cfg.num_experts > 0:
        y = moe_mlp(h2, layer.router, layer.e_gate, layer.e_up,
                    layer.e_down, cfg, rules)
        if cfg.moe_dense_residual:
            y = y + glu_mlp(h2, layer.r_gate, layer.r_up, layer.r_down,
                            cfg.mlp_act, rules)
    elif cfg.mlp_type == "plain":
        y = plain_mlp(h2, layer.w_up, layer.w_down, cfg.mlp_act, rules)
    else:
        y = glu_mlp(h2, layer.w_gate, layer.w_up, layer.w_down, cfg.mlp_act,
                    rules)
    s2 = wide(x) + wide(y)
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


def _weights(params, cfg: ModelConfig):
    """(embed, final_norm, head or None, layers) of the parameter tree;
    the layers are views made by one ``unbind`` of each stacked leaf."""
    G, P = _group_shape(cfg)
    cols = {n: w.reshape(G * P, *w.shape[2:]).unbind(0)
            for n, w in params["layers"].items()}
    layers = [types.SimpleNamespace(window=_layer_window(cfg, l % P),
                                    **{n: c[l] for n, c in cols.items()})
              for l in range(G * P)]
    return params["embed"], params["final_norm"], params.get("head"), layers


def forward(params, cfg: ModelConfig, rules: ShardingRules, tokens,
            positions, cache=None, inputs_embeds=None):
    """tokens (B, S) int (ignored where ``inputs_embeds`` is given);
    positions (S,) absolute; ``params`` the reference's parameter tree of
    tensors (autograd reaches its leaves).  ``inputs_embeds`` (B, S, D):
    the stream starts from it, cast to the config's dtype (no table
    lookup, no embed scale), as the vlm family feeds its patches.
    Returns (logits (B, S, V) fp32, cache | None); a cache is updated in
    place and returned."""
    _, P = _group_shape(cfg)
    embed, final_norm, head, layers = _weights(params, cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = embed_tokens(tokens, embed, rules, scale=cfg.embed_scale,
                         dtype=cfg.dtype)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def group(x, l0, *ws):
        # one scan group of the reference: P sublayers, the fp32 residual
        # sum passed between them
        x_hi = None
        for p, layer in enumerate(ws):
            l = l0 + p
            row = None if cache is None else _cache_row(cache, l, P,
                                                        layer.window)
            x, x_hi = _sublayer(x, x_hi, layer, cfg, rules, positions, row,
                                layer.window, angles)
        return x

    body = maybe_remat(group, cfg) if torch.is_grad_enabled() else group
    for l0 in range(0, len(layers), P):
        x = body(x, l0, *layers[l0:l0 + P])
    x = rms_norm(x, final_norm)
    head = embed.T if cfg.tie_embeddings else head
    return lm_head(x, head, cfg, rules), cache


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, cfg: ModelConfig, rules: ShardingRules,
            tokens, cache, inputs_embeds=None):
    """The prompt's S positions (``inputs_embeds``' S where given) written
    into ``cache`` from position 0."""
    S = (tokens if inputs_embeds is None else inputs_embeds).shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    return forward(params, cfg, rules, tokens, positions, cache=cache,
                   inputs_embeds=inputs_embeds)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, rules: ShardingRules,
                tokens, pos, cache):
    """tokens (B, 1); pos — the absolute position of the new token (an int,
    or a tensor on the tokens' device, which keeps the step free of host
    copies)."""
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=tokens.device).reshape(1)
    return forward(params, cfg, rules, tokens, positions, cache=cache)
