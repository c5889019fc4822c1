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

Every ``attn_shard`` mode runs this GQA path on one device.  The
reference's ``pad_heads`` branch pads the query heads and repeats K/V
per head, then slices the padding off, which is the same function.

Tensor parallelism over ``model`` (``common.TensorParallel``, set by the
sharded steps of ``train.step``), one part for each ``attn_shard``:

* ``heads`` (the rules split the param heads; H and KV divide the axis):
  the weights are this rank's heads; ``qkv_project`` takes its input
  through ``CopyToGroup``, ``attend`` runs on the local query and KV
  heads (a rank's query heads are those of its KV heads), and
  ``out_project`` sums the ranks' parts of the product.
* ``pad_heads`` (no weight split; the activation heads over ``model``):
  ``qkv_project`` computes q, k and v whole on every rank.  ``attend``
  with more than one query pads q to Hp = ``attn_pad_to`` heads, takes
  this rank's Hp / n of them (``SplitToGroup``: backward, the blocks'
  cotangents all-gathered), repeats K/V by the reference's ``kv_map`` for
  them (K and V through ``CopyToGroup``: backward, each rank's
  scatter-add of its heads' cotangents summed over the ranks), and runs
  the GQA core at one query head a KV head.  The context's real heads
  are then re-split into blocks of ceil(H / n) (``Reshard``, point to
  point), and ``out_project`` multiplies this rank's block by its rows of
  ``wo`` (``SplitToGroup``) and sums the ranks' parts.  So ``wq``,
  ``wk``, ``wv`` and ``wo`` get the same, whole gradient on every rank,
  as ``distributed.sharded.reduce_grad`` assumes of a leaf not split over
  ``model``.  A single query (decode) takes the plain path, whole on
  every rank: its parallelism is split-KV (``CacheShard``).
* ``head_dim`` (``wq``/``wk``/``wv`` split on their last dim, ``wo`` on
  its head dim): ``qkv_project`` projects this rank's columns, each
  projection's input through its own ``CopyToGroup``; RoPE pairs column
  j with j + hd/2, which the rank (r + n/2) mod n holds, so each rank
  receives its partner's block (``Reshard``) and rotates its own
  columns; ``attend`` sums the ranks' partial scores (fp32), and passes
  the probabilities through ``CopyToGroup`` (fp32) before the local
  context product, so their cotangent is summed; ``out_project`` sums
  the ranks' parts of the product over their head-dim rows.  A cache's
  head dim is whole: ``cache_write`` gathers K/V's columns, ``attend``
  reads its own columns of a whole one.

What the reference's compiled sharded step does (XLA on the CPU,
``lowered.compile().as_text()`` of reduced internlm2's AdamW step on a
(2, 2) mesh of Auto axes; 8 x 32 tokens, one layer): lowered without a
mesh context, as ``tests/test_torch_sharded_train.py`` runs it, its
``shard`` constraints raise inside the jit and are dropped (jax 0.9's
``with_sharding_constraint`` of a bare ``PartitionSpec`` wants a context
mesh); lowered under ``with mesh:``, as its dry run does, they hold.
Under ``with mesh:`` (the partition the port follows):

* ``pad_heads`` (``attn_pad_to = 6``): each rank computes q, k and v
  whole (``wq``/``wk``/``wv`` all-gathered over ``data`` only).  The
  padded heads split 3 + 3 with no collective.  The context reaches
  ``out_project`` as a row-split partial product followed by an
  all-reduce over ``model`` promoted to fp32 (``clone_promoted``: each
  rank's product rounded to bf16, summed in fp32, rounded once): the real
  heads are first re-split 2 + 2 by a collective-permute of one head
  (f32[4,32,1,16], rank 0 to rank 1), then multiplied by ``wo``'s rows of
  those heads.  The backward all-gathers q's padded-head cotangent over
  ``model`` (f32[4,32,6,16]) and sums K's and V's (each rank's
  scatter-add through the ``take``) in an all-reduce promoted to fp32, so
  the projections' backward, and ``wq``/``wk``/``wv``'s gradients, are
  whole and equal on every ``model`` rank; ``wo``'s is computed on each
  rank's heads and made whole by the sharding of the update.  Without a
  mesh context the padded heads are not split: every rank attends all 6.
* ``head_dim``: the score all-reduce over ``model`` is f32 (plain, not
  promoted: the scores are fp32 products).  RoPE runs on the split head
  dim through collective-permutes between the two ranks of a ``model``
  pair (f32 copies of the bf16 q and k, forward and backward), no
  all-gather.  The out-projection's all-reduce is bf16 promoted to fp32.
  The probabilities' cotangent is summed by an f32 all-reduce (not
  promoted), and x's gradient by one promoted all-reduce a projection (q,
  k, v apart).  The cache's spec keeps the head dim whole
  (``cache_specs``): the compiled prefill step (8 x 32 tokens into 32
  slots) all-gathers K's and V's columns over ``model`` before the write
  (f32[1,4,32,2,16] along the head dim), as ``cache_write`` does.

The port follows these where the choice changes the rounding: the
promoted sums, the fp32 score and probability sums, the head blocks of
``wo``'s partial products, one copy a projection under ``head_dim``.
Where only an exact operation's order or route changes it chooses its
own: the padded q's cotangent is gathered in its own dtype, RoPE's
exchange moves the whole bf16 partner block (no fp32 copy, no halving),
the context's permute moves bf16 heads, and ``wo``'s gradient is
all-gathered by ``SplitToGroup``.  A float64 config stays float64.

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
from .common import (P, ModelConfig, ShardingRules, in_dtype, rope,
                     rope_angles, softcap, tp_comm, tp_copy, tp_sum, wide)

_MASKED = -1e30


def qkv_project(x, wq, wk, wv, cfg: ModelConfig, rules: ShardingRules,
                positions, angles=None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied
    (``angles``: ``common.rope_angles`` of ``positions``, if made); this
    rank's heads under a tensor-parallel ``heads``, its head-dim columns
    under ``head_dim``."""
    cols = tp_comm("head_dim")
    if cols is not None:
        q, k, v = (torch.einsum("bsd,dhk->bshk", tp_copy(x, "head_dim"), w)
                   for w in (wq, wk, wv))
        return (_rope_cols(q, positions, cfg.rope_theta, angles, cols),
                _rope_cols(k, positions, cfg.rope_theta, angles, cols), v)
    x = tp_copy(x, "heads")
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    return (rope(q, positions, cfg.rope_theta, angles),
            rope(k, positions, cfg.rope_theta, angles), v)


def _rope_cols(x, positions, theta: float, angles, comm):
    """``common.rope`` of the head dim split over ``comm``'s ranks, ``x``
    (..., S, H, c) this rank's columns: column j pairs with j ± hd/2, held
    by the rank (r + n/2) mod n, whose block ``Reshard`` brings (its
    backward sends the cotangent back); each column is rotated as ``rope``
    rotates it.  n must be even (one rank: ``rope``)."""
    from ..distributed.sharded import Reshard

    n, c = comm.size, x.shape[-1]
    if n % 2:
        raise ValueError(f"RoPE over a head dim split over {n} ranks: its "
                         f"column pairs (j, j + hd/2) cross the ranks' "
                         f"blocks unless the 'model' axis is even")
    half = n * c // 2
    cos, sin = angles if angles is not None else rope_angles(
        positions, n * c, theta)
    own = [(j * c, (j + 1) * c) for j in range(n)]
    partner = Reshard.apply(x, comm, x.ndim - 1, own,
                            [own[(j + n // 2) % n] for j in range(n)])
    lo = comm.rank * c
    j0 = lo % half
    cos, sin = cos[..., j0:j0 + c], sin[..., j0:j0 + c]
    out = (x * cos - partner * sin if lo < half
           else x * cos + partner * sin)
    return out.to(x.dtype)


def whole_columns(t):
    """``t`` (..., c), this rank's head-dim columns under a
    tensor-parallel ``head_dim``, all-gathered whole (a cache's K/V; no
    gradient); ``t`` itself otherwise."""
    comm = tp_comm("head_dim")
    if comm is None:
        return t
    return comm.gather(t.movedim(-1, 0)).movedim(0, -1)


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
    cache (see the module's docstring).  Under a tensor-parallel
    ``pad_heads`` and more than one query, the context is this rank's
    block of ceil(H / n) heads (``out_project`` takes it so); under
    ``head_dim``, q holds this rank's columns, and a k and v whole in the
    head dim (a cache's) are read at them."""
    B, Sq, H, hd = q.shape
    if Sq == 0:
        return q.new_zeros(q.shape)
    seq = None if shard is None else shard.seq
    pad = tp_comm("pad_heads")
    if pad is not None and Sq > 1:
        if seq is not None:
            raise ValueError("a prompt of several queries over a cache whose "
                             "slots are split: the padded heads attend only "
                             "fresh K/V")
        return _attend_padded(q, k, v, q_pos, kv_pos, cfg, pad, window,
                              is_causal, q_chunk)
    cols = tp_comm("head_dim")
    if cols is not None:
        if k.shape[-1] != hd:                  # a cache's whole columns
            k, v = (t.narrow(-1, cols.rank * hd, hd) for t in (k, v))
        hd = hd * cols.size
    return _attend_core(q, k, v, q_pos, kv_pos, cfg, hd, window, is_causal,
                        q_chunk, seq, cols)


def _attend_core(q, k, v, q_pos, kv_pos, cfg: ModelConfig, hd: int,
                 window: int, is_causal: bool, q_chunk: int, seq, cols):
    """The GQA loop of ``attend``: ``hd`` the whole head dim (the scale's),
    ``seq`` the ranks splitting the slots or None, ``cols`` the ranks
    splitting the head dim (q, k and v their columns; the scores summed
    over them, the probabilities' cotangent too) or None."""
    B, Sq, H, c = q.shape
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
        qb = q[:, c0:c0 + qc].reshape(B, qc, KV, qpk, c)
        pb = q_pos[c0:c0 + qc]
        scores = torch.einsum("bqkgh,bskh->bkgqs", wide(qb * scale), kf)
        if cols is not None:
            scores = tp_sum(scores, "head_dim")
        scores = softcap(scores, cfg.attn_softcap)
        mask = live
        if is_causal:
            mask = mask & (kv_pos[None, :] <= pb[:, None])
        if window > 0:
            mask = mask & (kv_pos[None, :] > pb[:, None] - window)
        scores = torch.where(mask, scores, _MASKED)
        if seq is None:
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            ctx = torch.einsum("bkgqs,bskh->bqkgh",
                               tp_copy(wide(probs), "head_dim"), vf)
        else:
            # this rank's slots: partial sums, combined over the ranks
            m = scores.amax(dim=-1)
            p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
            o = torch.einsum("bkgqs,bskh->bkgqh",
                             tp_copy(wide(p.to(v.dtype)), "head_dim"), vf)
            ctx = softmax_combine(m, p.sum(dim=-1), o, seq).permute(
                0, 3, 1, 2, 4)
        out.append(ctx.reshape(B, qc, H, c).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _head_blocks(n: int, size: int, total: int):
    """The heads ``[lo, hi)`` of ``total`` each of ``n`` ranks holds in
    blocks of ``size`` (the last ones shorter or empty)."""
    return [(min(j * size, total), min((j + 1) * size, total))
            for j in range(n)]


def _attend_padded(q, k, v, q_pos, kv_pos, cfg: ModelConfig, comm, window,
                   is_causal, q_chunk):
    """The reference's ``pad_heads`` branch over ``comm``'s ranks (see the
    module's docstring): this rank's Hp / n padded heads attended, the
    real ones returned re-split into this rank's block of ceil(H / n)."""
    from ..distributed.sharded import Reshard, SplitToGroup

    B, Sq, H, hd = q.shape
    n, r = comm.size, comm.rank
    Hp = cfg.attn_pad_to or H
    if Hp % n:
        raise ValueError(f"{cfg.arch}: its {Hp} padded query heads "
                         f"(attn_pad_to) do not split over the {n} ranks "
                         f"of 'model'")
    hp = Hp // n
    qpk0 = H // max(k.shape[2], 1)
    kv_map = torch.tensor([h // qpk0 if h < H else 0
                           for h in range(r * hp, (r + 1) * hp)],
                          dtype=torch.long, device=k.device)
    ql = SplitToGroup.apply(q, comm, 2, Hp)
    kl = tp_copy(k, "pad_heads").index_select(2, kv_map)
    vl = tp_copy(v, "pad_heads").index_select(2, kv_map)
    ctx = _attend_core(ql, kl, vl, q_pos, kv_pos, cfg, hd, window,
                       is_causal, q_chunk, None, None)
    held = _head_blocks(n, hp, H)
    real = ctx[:, :, :held[r][1] - held[r][0]]
    return Reshard.apply(real, comm, 2, held,
                         _head_blocks(n, -(-H // n), H))


def out_project(ctx, wo, rules: ShardingRules):
    """The context's heads through ``wo``, the ranks' parts summed under a
    tensor-parallel ``heads`` or ``head_dim`` (``wo`` this rank's heads or
    head-dim rows), and under ``pad_heads`` for more than one query
    (``ctx`` this rank's block of heads from ``attend``, ``wo`` whole: its
    rows of the block taken by ``SplitToGroup``)."""
    cols = tp_comm("head_dim")
    if cols is not None:
        return tp_sum(torch.einsum("bshk,hkd->bsd", ctx, wo), "head_dim")
    pad = tp_comm("pad_heads")
    if pad is not None and ctx.shape[1] > 1:
        from ..distributed.sharded import SplitToGroup
        n = pad.size
        rows = SplitToGroup.apply(wo, pad, 0, n * -(-wo.shape[0] // n))
        return tp_sum(torch.einsum("bshk,hkd->bsd", ctx,
                                   rows[:ctx.shape[2]]), "pad_heads")
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
    before the write so slot indices never repeat.  Under a
    tensor-parallel ``head_dim`` the new K/V are this rank's columns,
    gathered whole first.  With a ``CacheShard``
    ``shard`` the layer holds this rank's slots: of the positions it
    writes those whose global slot it holds (a one-token write keeps the
    slot's old entry on the other ranks, with no host read)."""
    seq = None if shard is None else shard.seq
    if k_new.shape[-1] != layer_k.shape[-1]:
        k_new, v_new = whole_columns(k_new), whole_columns(v_new)
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
