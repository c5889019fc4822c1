"""GQA/MQA attention (port of ``repro.models.attention``): causal full,
sliding-window (local) and local/global attention, the attention-logit
softcap (gemma2), RoPE, and position-indexed KV caches (full and
rolling-window) for serving.

Positions are explicit everywhere: masks are built from the absolute
positions of queries and cache slots (-1 = an empty slot), so one path
serves training, prefill, full-cache decode and rolling-window decode.
The score and context products accumulate in fp32 (both operands upcast,
as the reference's ``preferred_element_type=float32``), the softmax runs in
fp32 and its probabilities are cast to the values' dtype.

On one card there is no tensor parallelism: every ``attn_shard`` mode runs
this GQA path.  The reference's ``pad_heads`` branch pads the query heads
and repeats K/V per head, then slices the padding off, which is the same
function.  No ``scaled_dot_product_attention``: it has no logit softcap
and masks by another arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .common import (P, ModelConfig, ShardingRules, in_dtype, rope, softcap,
                     wide)

_MASKED = -1e30


def qkv_project(x, wq, wk, wv, cfg: ModelConfig, rules: ShardingRules,
                positions, angles=None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied
    (``angles``: ``common.rope_angles`` of ``positions``, if made)."""
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    return (rope(q, positions, cfg.rope_theta, angles),
            rope(k, positions, cfg.rope_theta, angles), v)


def _pick_chunk(sq: int, want: int) -> int:
    qc = min(want, sq)
    while sq % qc:
        qc -= 1
    return qc


def attend(q, k, v, q_pos, kv_pos, cfg: ModelConfig, rules: ShardingRules,
           *, window: int = 0, is_causal: bool = True, q_chunk: int = 512):
    """Core attention, query-chunked so the live score block is
    (B, KV, qpk, qc, Skv).

    q (B,Sq,H,hd); k,v (B,Skv,KV,hd); q_pos (Sq,), kv_pos (Skv,) absolute
    positions (-1 marks empty cache slots).  No queries (an encoder fed
    zero frames) give no context; no keys give a zero context."""
    B, Sq, H, hd = q.shape
    if Sq == 0:
        return q.new_zeros(q.shape)
    KV = k.shape[2]
    qpk = H // KV
    scale = in_dtype(hd ** -0.5, q.dtype)
    qc = _pick_chunk(Sq, q_chunk)
    kf, vf = wide(k), wide(v)
    live = kv_pos[None, :] >= 0
    out = []
    for c0 in range(0, Sq, qc):
        qb = q[:, c0:c0 + qc].reshape(B, qc, KV, qpk, hd)
        pb = q_pos[c0:c0 + qc]
        scores = torch.einsum("bqkgh,bskh->bkgqs", wide(qb * scale), kf)
        scores = softcap(scores, cfg.attn_softcap)
        mask = live
        if is_causal:
            mask = mask & (kv_pos[None, :] <= pb[:, None])
        if window > 0:
            mask = mask & (kv_pos[None, :] > pb[:, None] - window)
        scores = torch.where(mask, scores, _MASKED)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bkgqs,bskh->bqkgh", wide(probs), vf)
        out.append(ctx.reshape(B, qc, H, hd).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def out_project(ctx, wo, rules: ShardingRules):
    return torch.einsum("bshk,hkd->bsd", ctx, wo)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer-stack cache: k/v (L, B, C, KV, hd); slot_pos (L, C) absolute
    positions of the stored entries (-1 empty); ``window > 0`` makes C a
    rolling buffer.  The port updates a cache in place (``cache_write``):
    ``forward`` returns the same tensors it was given."""
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor


def init_kv_cache(num_layers: int, batch: int, capacity: int,
                  cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """A zeroed cache on ``device`` (default the card; a missing card
    raises)."""
    device = resolve_device(device)
    shape = (num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((num_layers, capacity), -1, dtype=torch.int32,
                            device=device))


def cache_specs(rules: ShardingRules, kv_sharded: bool = True) -> KVCache:
    """The cache's ``PartitionSpec``s under ``rules`` (``kv_sharded=False``
    keeps the KV heads whole)."""
    kv = rules.kv_heads if kv_sharded else None
    spec = P(None, rules.resolve("batch"), rules.kv_seq, kv, None)
    return KVCache(k=spec, v=spec, slot_pos=P(None, rules.kv_seq))


def cache_shapes(num_layers: int, batch: int, capacity: int,
                 cfg: ModelConfig, dtype=torch.bfloat16):
    """``meta`` tensors of a cache's shapes (no allocation)."""
    return init_kv_cache(num_layers, batch, capacity, cfg, dtype,
                         device="meta")


def cache_write(layer_k, layer_v, layer_pos, k_new, v_new, positions,
                window: int):
    """Write S_new entries at their (possibly wrapped) slots of ONE layer,
    in place: k/v (B, C, KV, hd), slot_pos (C,).  Returns them.

    Rolling buffers (window > 0): if more entries than the capacity arrive
    at once (windowed prefill), only the last C survive — they are sliced
    before the write so slot indices never repeat."""
    C = layer_k.shape[1]
    S = k_new.shape[1]
    if window > 0:
        if S > C:
            k_new, v_new = k_new[:, -C:], v_new[:, -C:]
            positions = positions[-C:]
        slots = positions.long() % C
    else:
        slots = positions.long()
    layer_k[:, slots] = k_new.to(layer_k.dtype)
    layer_v[:, slots] = v_new.to(layer_v.dtype)
    layer_pos[slots] = positions.to(torch.int32)
    return layer_k, layer_v, layer_pos
