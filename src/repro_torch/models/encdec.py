"""Encoder-decoder transformer (port of ``repro.models.encdec``), the
seamless-m4t backbone.

The speech/text frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, T, D); the decoder is a causal
stack with cross-attention into the encoder's output.  Training
(``forward_train``) computes each layer's cross K/V from the encoder's
output inside the layer; serving's ``prefill`` encodes, computes every
layer's cross K/V once, casts them to the cache's dtype (a rounding that
training does not have) and stores them, then runs the decoder's prefill
through the self-attention cache; ``decode_step`` extends only the
decoder, reading the cross K/V from the cache.  Cross-attention is
non-causal; ``enc_pos`` (``arange(T_enc)``) masks nothing and stays in the
cache as the reference keeps it.  Zero frames encode to an empty output,
and the cross-attention over no keys adds nothing (the reference's
attention raises on zero queries, ``0 % 0`` in its chunk choice).

Numerics as ``transformer``'s: bf16 products, fp32 norms and attention
accumulation, each residual sum reaching the next norm in fp32 while the
stream is rounded to bf16 (a layer is one step of the reference's scan,
its carry bf16).  Each encoder and decoder layer runs under
``cfg.remat``.  Self-attention caches are written in place.
``cache_specs`` gives the cache's ``PartitionSpec``s under a
``ShardingRules``, as the reference's.  Under the sharded serve steps
(``attention.cache_shard``) the cache's cross K/V are this rank's block
over ``kv_seq`` and ``kv_heads`` (prefill stores that block of the whole
cross K/V), and the cross-attention reads the positions of its own
frames; ``enc_pos`` stays whole.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..device import resolve_device
from . import attention as attn
from .common import (P, Builder, ModelConfig, ShardingRules, embed_tokens,
                     glu_mlp, lm_head, maybe_remat, rms_norm, rope_angles,
                     tp_copy, unbind_layers, wide)


class EncDecCache(NamedTuple):
    self_kv: attn.KVCache      # (L_dec, B, C, KV, hd)
    cross_k: torch.Tensor      # (L_dec, B, T_enc, KV, hd)
    cross_v: torch.Tensor
    enc_pos: torch.Tensor      # (T_enc,) positions (an arange, kept)
    pos: torch.Tensor


def _enc_layer_params(b: Builder, name: str, n: int, cfg: ModelConfig):
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    return {
        "ln1": b(f"{name}.ln1", (n, D), (None, None), init="zeros"),
        "wq": b(f"{name}.wq", (n, D, H, hd), (None, "fsdp", "heads", "head_dim")),
        "wk": b(f"{name}.wk", (n, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "wv": b(f"{name}.wv", (n, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "wo": b(f"{name}.wo", (n, H, hd, D), (None, "heads", "head_dim", "fsdp")),
        "ln2": b(f"{name}.ln2", (n, D), (None, None), init="zeros"),
        "w_gate": b(f"{name}.w_gate", (n, D, F), (None, "fsdp", "d_ff")),
        "w_up": b(f"{name}.w_up", (n, D, F), (None, "fsdp", "d_ff")),
        "w_down": b(f"{name}.w_down", (n, F, D), (None, "d_ff", "fsdp")),
    }


def _num_dec(cfg: ModelConfig) -> int:
    return cfg.num_decoder_layers or cfg.num_layers


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    """The reference's parameter tree, built by ``b``, in its order."""
    Le, Ld = cfg.num_layers, _num_dec(cfg)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dec = _enc_layer_params(b, "dec", Ld, cfg)
    dec.update({
        "lnx": b("dec.lnx", (Ld, D), (None, None), init="zeros"),
        "xq": b("dec.xq", (Ld, D, H, hd), (None, "fsdp", "heads", "head_dim")),
        "xk": b("dec.xk", (Ld, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "xv": b("dec.xv", (Ld, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "xo": b("dec.xo", (Ld, H, hd, D), (None, "heads", "head_dim", "fsdp")),
    })
    return {
        "embed": b("embed", (cfg.vocab_size, D), ("vocab", "fsdp")),
        "enc_norm": b("enc_norm", (D,), (None,), init="zeros"),
        "final_norm": b("final_norm", (D,), (None,), init="zeros"),
        "encoder": _enc_layer_params(b, "enc", Le, cfg),
        "decoder": dec,
    }


def _residual(x, y):
    """(the bf16 stream, its fp32 sum) after adding ``y`` to the bf16
    stream ``x``."""
    s = wide(x) + wide(y)
    return s.to(x.dtype), s


def _mlp(x, s, lp, cfg: ModelConfig, rules: ShardingRules):
    h2 = rms_norm(s, lp.ln2).to(x.dtype)
    return _residual(x, glu_mlp(h2, lp.w_gate, lp.w_up, lp.w_down,
                                cfg.mlp_act, rules))[0]


def _positions(n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(params, cfg: ModelConfig, rules: ShardingRules, frames):
    """frames (B, T, D) precomputed frontend embeddings -> (B, T, D) in
    the config's dtype: non-causal self-attention layers, then
    ``enc_norm``."""
    x = frames.to(cfg.dtype)
    positions = _positions(x.shape[1], x.device)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def layer(x, lp):
        h = rms_norm(x, lp.ln1)
        q, k, v = attn.qkv_project(h, lp.wq, lp.wk, lp.wv, cfg, rules,
                                   positions, angles)
        ctx = attn.attend(q, k, v, positions, positions, cfg, rules,
                          is_causal=False)
        x, s = _residual(x, attn.out_project(ctx, lp.wo, rules))
        return _mlp(x, s, lp, cfg, rules)

    body = maybe_remat(layer, cfg) if torch.is_grad_enabled() else layer
    for lp in unbind_layers(params["encoder"], cfg.num_layers):
        x = body(x, lp)
    return rms_norm(x, params["enc_norm"])


def _cross_kv(enc_out, wk, wv):
    """The cross K/V of ``enc_out`` (under a tensor-parallel ``head_dim``
    this rank's columns, each projection's input through its own
    ``CopyToGroup``, as ``attention.qkv_project``'s)."""
    return (torch.einsum("btd,dhk->bthk", tp_copy(enc_out, "head_dim"), wk),
            torch.einsum("btd,dhk->bthk", tp_copy(enc_out, "head_dim"), wv))


def _decode_stack(params, cfg: ModelConfig, rules: ShardingRules, x,
                  positions, enc_out=None,
                  cache: Optional[EncDecCache] = None):
    """The decoder over x (B, S, D): either ``enc_out`` (training: each
    layer's cross K/V computed here) or ``cache`` (its self-attention rows
    written in place, its cross K/V read).  Returns (x, the cache with
    ``pos`` advanced by S, or None)."""
    use_cache = cache is not None
    shard = attn.cache_shard() if use_cache else None
    if enc_out is not None:
        enc_pos = _positions(enc_out.shape[1], x.device)
        # every layer's cross K/V of this rank's heads read it
        enc_out = tp_copy(enc_out, "heads")
    else:
        enc_pos = attn.local_positions(cache.cross_k.shape[2], shard,
                                       x.device)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def layer(x, l, lp):
        h = rms_norm(x, lp.ln1)
        q, k, v = attn.qkv_project(h, lp.wq, lp.wk, lp.wv, cfg, rules,
                                   positions, angles)
        if use_cache:
            kv = cache.self_kv
            ck, cv, cpos = attn.cache_write(kv.k[l], kv.v[l], kv.slot_pos[l],
                                            k, v, positions, 0, shard)
            ctx = attn.attend(q, ck, cv, positions, cpos, cfg, rules,
                              shard=shard)
        else:
            ctx = attn.attend(q, k, v, positions, positions, cfg, rules)
        x, s = _residual(x, attn.out_project(ctx, lp.wo, rules))

        hx = tp_copy(tp_copy(rms_norm(s, lp.lnx).to(x.dtype), "heads"),
                     "head_dim")
        qx = torch.einsum("bsd,dhk->bshk", hx, lp.xq)
        if use_cache:
            xk, xv = cache.cross_k[l], cache.cross_v[l]
        else:
            xk, xv = _cross_kv(enc_out, lp.xk, lp.xv)
        ctxx = attn.attend(qx, xk, xv, positions, enc_pos, cfg, rules,
                           is_causal=False, shard=shard)
        x, s = _residual(x, attn.out_project(ctxx, lp.xo, rules))
        return _mlp(x, s, lp, cfg, rules)

    body = maybe_remat(layer, cfg) if torch.is_grad_enabled() else layer
    for l, lp in enumerate(unbind_layers(params["decoder"], _num_dec(cfg))):
        x = body(x, l, lp)
    if not use_cache:
        return x, None
    return x, cache._replace(pos=cache.pos + x.shape[1])


def _head(params, cfg: ModelConfig, rules: ShardingRules, x):
    x = rms_norm(x, params["final_norm"])
    return lm_head(x, params["embed"].T, cfg, rules)


def _embed(params, cfg: ModelConfig, rules: ShardingRules, tokens):
    return embed_tokens(tokens, params["embed"], rules,
                        scale=cfg.embed_scale, dtype=cfg.dtype)


def forward_train(params, cfg: ModelConfig, rules: ShardingRules, frames,
                  dec_tokens):
    """Training: encode the frames, teacher-forced decode; returns (logits
    (B, S, V) fp32, None)."""
    enc_out = encode(params, cfg, rules, frames)
    positions = _positions(dec_tokens.shape[1], dec_tokens.device)
    x = _embed(params, cfg, rules, dec_tokens)
    x, _ = _decode_stack(params, cfg, rules, x, positions, enc_out=enc_out)
    return _head(params, cfg, rules, x), None


@torch.no_grad()
def prefill(params, cfg: ModelConfig, rules: ShardingRules, frames,
            dec_tokens, cache: EncDecCache):
    """Encode, store every layer's cross K/V in the cache's dtype (they
    replace the cache's, whose length they take), then the decoder's
    prefill through the self-attention cache from position 0."""
    enc_out = encode(params, cfg, rules, frames)
    dec = params["decoder"]
    kvs = [_cross_kv(enc_out, wk, wv)
           for wk, wv in zip(dec["xk"].unbind(0), dec["xv"].unbind(0))]
    shard = attn.cache_shard()
    cache = cache._replace(**{
        name: attn.local_slots(attn.whole_columns(torch.stack(
            [t[i] for t in kvs])), shard, 2).to(getattr(cache, name).dtype)
        for i, name in enumerate(("cross_k", "cross_v"))})
    del kvs
    positions = _positions(dec_tokens.shape[1], dec_tokens.device)
    x = _embed(params, cfg, rules, dec_tokens)
    x, cache = _decode_stack(params, cfg, rules, x, positions, cache=cache)
    return _head(params, cfg, rules, x), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, rules: ShardingRules, tokens, pos,
                cache: EncDecCache):
    """tokens (B, 1) at the absolute position ``pos`` (an int, or a tensor
    on the tokens' device)."""
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=tokens.device).reshape(1)
    x = _embed(params, cfg, rules, tokens)
    x, cache = _decode_stack(params, cfg, rules, x, positions, cache=cache)
    return _head(params, cfg, rules, x), cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, t_enc: int,
               dtype=None, device=None) -> EncDecCache:
    """A zeroed cache on ``device`` (default the card; a missing card
    raises), in ``dtype`` (default the config's): the decoder's
    self-attention over ``capacity`` positions and the cross K/V of
    ``t_enc`` frames."""
    Ld = _num_dec(cfg)
    dtype = dtype or cfg.dtype
    if device != "meta":
        device = resolve_device(device)
    kvshape = (Ld, batch, t_enc, cfg.num_kv_heads, cfg.head_dim)
    return EncDecCache(
        self_kv=attn.init_kv_cache(Ld, batch, capacity, cfg, dtype,
                                   device=device),
        cross_k=torch.zeros(kvshape, dtype=dtype, device=device),
        cross_v=torch.zeros(kvshape, dtype=dtype, device=device),
        enc_pos=torch.arange(t_enc, dtype=torch.int32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def cache_specs(rules: ShardingRules) -> EncDecCache:
    """The cache's ``PartitionSpec``s under ``rules``."""
    bt = rules.resolve("batch")
    kv = rules.kv_heads
    return EncDecCache(
        self_kv=attn.cache_specs(rules),
        cross_k=P(None, bt, rules.kv_seq, kv, None),
        cross_v=P(None, bt, rules.kv_seq, kv, None),
        enc_pos=P(None), pos=P())


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int, t_enc: int,
                 dtype=None) -> EncDecCache:
    """``meta`` tensors of a cache's shapes (no allocation)."""
    return init_cache(cfg, batch, capacity, t_enc, dtype, device="meta")
