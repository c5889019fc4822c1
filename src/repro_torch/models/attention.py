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

Every ``attn_shard`` mode runs this GQA path.  The reference's
``pad_heads`` branch pads the query heads and repeats K/V per head, then
slices the padding off, which is the same function.  Under a
``common.TensorParallel`` with ``heads`` (the sharded steps, where the
rules split the param heads over ``model`` and both H and KV divide it)
the weights are this rank's heads: ``qkv_project`` takes its input
through ``CopyToGroup``, ``attend`` runs on the local query and KV heads
(a rank's query heads are those of its KV heads), and ``out_project``
sums the ranks' parts of the product.  No
``scaled_dot_product_attention``: it has no logit softcap and masks by
another arithmetic.

Under the sharded serve steps (``train.step``) a cache is this rank's
shard of one placed over a mesh by ``cache_specs``.  Its KV heads split
over ``rules.kv_heads`` are the local heads of the tensor-parallel
attention above.  Its slots split over ``rules.kv_seq`` (split-KV and
context-parallel decode): the step sets a ``CacheShard``
(``local_cache``) that ``cache_shard()`` returns; ``cache_write`` writes
a position only on the rank that holds its global slot (``pos``, or
``pos % C`` for a rolling buffer of ``C`` slots in all, less the rank's
offset), and ``attend`` over the local slots takes each rank's partial
softmax sums and combines them (``distributed.sharded.softmax_combine``);
the masks read the local ``slot_pos``, which holds absolute positions.
Without a ``CacheShard`` (one device, or no slots split) the code path
is the one-device one.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from .common import (P, ModelConfig, ShardingRules, in_dtype, rope, softcap,
                     tp_copy, tp_sum, wide)

_MASKED = -1e30


def qkv_project(x, wq, wk, wv, cfg: ModelConfig, rules: ShardingRules,
                positions, angles=None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied
    (``angles``: ``common.rope_angles`` of ``positions``, if made); this
    rank's heads under a tensor-parallel ``heads``."""
    x = tp_copy(x, "heads")
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


class CacheShard(NamedTuple):
    """This rank's part of a cache placed over a mesh: ``seq``, the ranks
    that split its slots (``rules.kv_seq``), a
    ``distributed.sharded.AxisComm``."""
    seq: Any


_SHARD: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_cache_shard", default=None)


def shard_of(mesh, rules: ShardingRules):
    """The ``CacheShard`` of a cache placed by ``cache_specs(rules)`` on
    ``mesh``, or None when its slots are not split."""
    from ..distributed.sharded import AxisComm

    entry = rules.kv_seq
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    if not axes:
        return None
    comm = AxisComm(mesh, axes)
    return CacheShard(seq=comm) if comm.size > 1 else None


@contextlib.contextmanager
def local_cache(shard):
    """Within: the caches the model code gets are this rank's shards as
    ``shard`` (a ``CacheShard`` or None) describes."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def cache_shard():
    """The ``CacheShard`` the sharded serve step set, or None."""
    return _SHARD.get()


def local_slots(t, shard, seq_dim: int):
    """This rank's block of the K/V ``t`` along ``seq_dim`` over
    ``shard.seq``'s ranks."""
    if shard is None:
        return t
    per = t.shape[seq_dim] // shard.seq.size
    return t.narrow(seq_dim, shard.seq.rank * per, per)


def local_positions(n: int, shard, device):
    """The positions of this rank's ``n`` slots of an ``arange`` split
    over ``shard.seq``'s ranks (an encoder's frames)."""
    off = 0 if shard is None or shard.seq is None else shard.seq.rank * n
    return torch.arange(off, off + n, dtype=torch.int32, device=device)


def attend(q, k, v, q_pos, kv_pos, cfg: ModelConfig, rules: ShardingRules,
           *, window: int = 0, is_causal: bool = True, q_chunk: int = 512,
           shard=None):
    """Core attention, query-chunked so the live score block is
    (B, KV, qpk, qc, Skv).

    q (B,Sq,H,hd); k,v (B,Skv,KV,hd); q_pos (Sq,), kv_pos (Skv,) absolute
    positions (-1 marks empty cache slots).  No queries (an encoder fed
    zero frames) give no context; no keys give a zero context.  With a
    ``CacheShard`` ``shard``, k, v and kv_pos are this rank's slots of a
    cache (see the module's docstring)."""
    B, Sq, H, hd = q.shape
    if Sq == 0:
        return q.new_zeros(q.shape)
    seq = None if shard is None else shard.seq
    if seq is not None:
        from ..distributed.sharded import softmax_combine
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
        if seq is None:
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            ctx = torch.einsum("bkgqs,bskh->bqkgh", wide(probs), vf)
        else:
            # this rank's slots: partial sums, combined over the ranks
            m = scores.amax(dim=-1)
            p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
            o = torch.einsum("bkgqs,bskh->bkgqh", wide(p.to(v.dtype)), vf)
            ctx = softmax_combine(m, p.sum(dim=-1), o, seq).permute(
                0, 3, 1, 2, 4)
        out.append(ctx.reshape(B, qc, H, hd).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def out_project(ctx, wo, rules: ShardingRules):
    """The context's heads through ``wo``, the ranks' parts summed under a
    tensor-parallel ``heads``."""
    return tp_sum(torch.einsum("bshk,hkd->bsd", ctx, wo), "heads")


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
                window: int, shard=None):
    """Write S_new entries at their (possibly wrapped) slots of ONE layer,
    in place: k/v (B, C, KV, hd), slot_pos (C,).  Returns them.

    Rolling buffers (window > 0): if more entries than the capacity arrive
    at once (windowed prefill), only the last C survive — they are sliced
    before the write so slot indices never repeat.  With a ``CacheShard``
    ``shard`` the layer holds this rank's slots: of the positions it
    writes those whose global slot it holds (a one-token write keeps the
    slot's old entry on the other ranks, with no host read)."""
    seq = None if shard is None else shard.seq
    C = layer_k.shape[1]
    whole = C if seq is None else C * seq.size
    S = k_new.shape[1]
    if window > 0:
        if S > whole:
            k_new, v_new = k_new[:, -whole:], v_new[:, -whole:]
            positions = positions[-whole:]
        slots = positions.long() % whole
    else:
        slots = positions.long()
    if seq is not None:
        slots = slots - seq.rank * C
        held = (slots >= 0) & (slots < C)
        if slots.shape[0] == 1:
            slots = slots.clamp(0, C - 1)
            k_new = torch.where(held[:, None, None], k_new.to(layer_k.dtype),
                                layer_k[:, slots])
            v_new = torch.where(held[:, None, None], v_new.to(layer_v.dtype),
                                layer_v[:, slots])
            positions = torch.where(held, positions.to(torch.int32),
                                    layer_pos[slots])
        else:
            keep = held.nonzero()[:, 0]
            k_new, v_new = k_new[:, keep], v_new[:, keep]
            positions, slots = positions[keep], slots[keep]
    layer_k[:, slots] = k_new.to(layer_k.dtype)
    layer_v[:, slots] = v_new.to(layer_v.dtype)
    layer_pos[slots] = positions.to(torch.int32)
    return layer_k, layer_v, layer_pos
