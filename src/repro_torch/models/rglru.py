"""RecurrentGemma / Griffin hybrid (port of ``repro.models.rglru``): RG-LRU
recurrent blocks and local MQA attention in a (rec, rec, attn)-style 1:2
pattern, arXiv:2402.19427.

Layer layout (``_layout``): ``num_layers % 3`` leading recurrent layers
(``params["lead"]``, stacked ``(lead, ...)``), then ``num_layers // 3``
groups of (attention, recurrent, recurrent) (``params["groups"]``'s
``attn``, ``rec_a`` and ``rec_b``, each stacked ``(G, ...)``): 2 + 12
groups at 38 layers, 1 + 1 at 4, 2 + 1 at 5 (the reduced config).

The RG-LRU is the gated linear recurrence

    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
    a_t = exp(-c · softplus(Λ) · σ(W_a x_t)),

computed by ``associative_scan``, the port of ``jax.lax.associative_scan``
(combine adjacent pairs, recurse on the odd half, combine the evens,
interleave), so the reference's combines run in the reference's tree and
the fp32 roundings follow; decode is the same scan at S = 1 from the
cached state.  A layer with a cache writes its new state, conv rows and
K/V into the cache in place.

Numerics follow the reference's compiled graph (XLA on the CPU, read from
``jax.jit(...).lower(...).compile().as_text()`` of ``_rec_sublayer``
forward and backward), bf16 where the reference's arrays are bf16:

* the projections ``h @ w_y``, ``h @ w_x``, the gates ``xb @ w_a``,
  ``xb @ w_i`` and ``(y * y_branch) @ w_out`` are bf16 products;
  ``gelu(approximate=True)`` runs op by op in bf16 (``common._gelu_tanh``);
* the depthwise causal conv is op by op in bf16 (each of the four products
  and each partial sum rounded); the bias is added in fp32, and that sum
  is rounded to bf16 for the gate products but enters ``x ⊙ σ(gates_i)``
  unrounded (the compiled graph drops that rounding);
* ``_rg_lru`` runs in fp32 from its bf16 inputs, the scan's
  ``a_r b_l + b_r`` one fused multiply-add; softplus as
  ``logaddexp(x, 0)``, σ as 1 / (1 + e^-x), a² as exp(2 log a) (the
  compiled graph's rewrite of a · a), the clip ``maximum(1 - a², 1e-6)``
  against the constant; ``h`` is rounded to bf16, the last state stays
  fp32 and the cache keeps it in fp32;
* ``y * y_branch`` is a bf16 product; each residual sum reaches the next
  norm in fp32 and the residual stream is rounded to bf16 (as in
  ``transformer``), and across the layers of one scan group of the
  reference (attention, rec_a, rec_b) and across the leading layers the
  next layer's norm also reads the fp32 sum; the stream entering a group
  is bf16 (the reference's scan carry).

Each group runs under ``cfg.remat`` (the reference's ``maybe_remat`` over
its scan body); the leading layers run outside it.  ``cache_specs``
gives the cache's ``PartitionSpec``s under a ``ShardingRules``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..device import resolve_device
from . import attention as attn
from .common import (P, Builder, ModelConfig, ShardingRules, _Logistic,
                     _Softplus, _gelu_tanh, embed_tokens, glu_mlp, lm_head,
                     maybe_remat, rms_norm, rope_angles, unbind_layers, wide)

_C = 8.0  # Griffin's fixed recurrence sharpness


class HybridCache(NamedTuple):
    kv: attn.KVCache          # attention layers only (n_attn, B, W, KV, hd)
    state: torch.Tensor       # (n_rec, B, rnn_width) RG-LRU states, fp32
    conv: torch.Tensor        # (n_rec, B, K-1, rnn_width)
    pos: torch.Tensor         # () int32


def _layout(cfg: ModelConfig):
    """-> (n_lead_rec, n_groups); group = (attn, rec, rec)."""
    period = cfg.rnn_block_period or 3
    return cfg.num_layers % period, cfg.num_layers // period


def _rec_param_group(b: Builder, name: str, n: int, cfg: ModelConfig):
    D, R = cfg.d_model, cfg.rnn_width or cfg.d_model
    K = 4
    return {
        "ln": b(f"{name}.ln", (n, D), (None, None), init="zeros"),
        "w_y": b(f"{name}.w_y", (n, D, R), (None, "fsdp", "d_ff")),
        "w_x": b(f"{name}.w_x", (n, D, R), (None, "fsdp", "d_ff")),
        "conv_w": b(f"{name}.conv_w", (n, K, R), (None, None, "d_ff")),
        "conv_b": b(f"{name}.conv_b", (n, R), (None, "d_ff"), init="zeros"),
        "w_a": b(f"{name}.w_a", (n, R, R), (None, "d_ff", None)),
        "w_i": b(f"{name}.w_i", (n, R, R), (None, "d_ff", None)),
        "lam": b(f"{name}.lam", (n, R), (None, "d_ff"), init="ones"),
        "w_out": b(f"{name}.w_out", (n, R, D), (None, "d_ff", "fsdp")),
        "ln2": b(f"{name}.ln2", (n, D), (None, None), init="zeros"),
        "m_gate": b(f"{name}.m_gate", (n, D, cfg.d_ff), (None, "fsdp", "d_ff")),
        "m_up": b(f"{name}.m_up", (n, D, cfg.d_ff), (None, "fsdp", "d_ff")),
        "m_down": b(f"{name}.m_down", (n, cfg.d_ff, D), (None, "d_ff", "fsdp")),
    }


def _attn_param_group(b: Builder, name: str, n: int, cfg: ModelConfig):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "ln": b(f"{name}.ln", (n, D), (None, None), init="zeros"),
        "wq": b(f"{name}.wq", (n, D, H, hd), (None, "fsdp", "heads", "head_dim")),
        "wk": b(f"{name}.wk", (n, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "wv": b(f"{name}.wv", (n, D, KV, hd), (None, "fsdp", "kv_heads", "head_dim")),
        "wo": b(f"{name}.wo", (n, H, hd, D), (None, "heads", "head_dim", "fsdp")),
        "ln2": b(f"{name}.ln2", (n, D), (None, None), init="zeros"),
        "m_gate": b(f"{name}.m_gate", (n, D, cfg.d_ff), (None, "fsdp", "d_ff")),
        "m_up": b(f"{name}.m_up", (n, D, cfg.d_ff), (None, "fsdp", "d_ff")),
        "m_down": b(f"{name}.m_down", (n, cfg.d_ff, D), (None, "d_ff", "fsdp")),
    }


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    """The reference's parameter tree, built by ``b``, in its order."""
    lead, G = _layout(cfg)
    params = {
        "embed": b("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "fsdp")),
        "final_norm": b("final_norm", (cfg.d_model,), (None,), init="zeros"),
        "groups": {
            "attn": _attn_param_group(b, "g.attn", G, cfg),
            "rec_a": _rec_param_group(b, "g.rec_a", G, cfg),
            "rec_b": _rec_param_group(b, "g.rec_b", G, cfg),
        },
    }
    if lead:
        params["lead"] = _rec_param_group(b, "lead", lead, cfg)
    return params


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _interleave(a, b, dim: int):
    """a[0], b[0], a[1], b[1], ... along ``dim`` (a one longer, or as long)."""
    n = b.shape[dim]
    out = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(
        dim, dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, a.narrow(dim, n, 1)], dim=dim)
    return out


def associative_scan(fn, elems, dim: int = 0):
    """The inclusive scan of the tuple of tensors ``elems`` along ``dim``
    under the associative ``fn(left, right) -> combined`` (each a tuple
    like ``elems``): ``jax.lax.associative_scan``'s algorithm, the same
    combines in the same tree (adjacent pairs combined, the scan of those
    recursively, the even positions combined with it, the two interleaved),
    in strided slices and ``torch.cat``/``stack``, so autograd
    differentiates it; log2(S) levels."""
    elems = tuple(elems)
    dim = dim % elems[0].ndim

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in es),
                     tuple(sl(e, 1, None, 2) for e in es))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in es))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in es))
        even = [torch.cat([sl(e, 0, 1), r], dim=dim)
                for e, r in zip(es, even)]
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    return scan(elems)


def _lru_combine(l, r):
    """(a_l a_r, a_r b_l + b_r), the second as one fused multiply-add
    (``addcmul``): the reference's compiled graph contracts it so."""
    al, bl = l
    ar, br = r
    return al * ar, torch.addcmul(br, ar, bl)


def _rg_lru(x, gates_a, gates_i, lam, h0=None, dtype=None):
    """x (B,S,R); returns (y (B,S,R) in ``dtype`` (default x's), h_last
    (B,R) in the working dtype).  fp32 internals (float64 kept)."""
    a_log = (-_C * _Softplus.apply(wide(lam))) * _Logistic.apply(
        wide(gates_a))                                             # log a_t
    a = torch.exp(a_log)
    gated_x = wide(x) * _Logistic.apply(wide(gates_i))
    # eps floor: d/da sqrt(1-a²) = -a/sqrt(1-a²) blows up as a -> 1
    floor = torch.tensor(1e-6, dtype=a.dtype, device=a.device)
    b_t = torch.sqrt(torch.maximum(1.0 - torch.exp(a_log + a_log), floor)) \
        * gated_x
    h = _lru_scan(a, b_t, h0)
    return h.to(dtype or x.dtype), h[:, -1]


def _lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t along dim 1 of a, b (B, S, R) from h_{-1} =
    ``h0`` (B, R) (zeros if None): ``h0``'s term folded into b_0, then
    ``associative_scan``."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * wide(h0)[:, None], b[:, 1:]],
                      dim=1)
    return associative_scan(_lru_combine, (a, b), dim=1)[1]


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------

def _rec_sublayer(x, lp, cfg: ModelConfig, rules: ShardingRules,
                  cache_row=None, x_hi=None):
    """One recurrent block on x (B, S, D); ``lp`` its weights by name;
    ``x_hi``: the fp32 sum behind ``x`` when the previous layer runs in
    the same compiled region, else None.  cache_row: None or (state (B,
    R), conv (B, K-1, R)).  Returns (the bf16 stream, its fp32 sum, (new
    state, new conv) or None)."""
    B, S, _ = x.shape
    dt = x.dtype
    h = rms_norm(x if x_hi is None else x_hi, lp.ln).to(dt)
    y_branch = _gelu_tanh(h @ lp.w_y)
    xb = h @ lp.w_x
    # depthwise causal conv (k=4), op by op in xb's dtype
    K = lp.conv_w.shape[0]
    prev = None if cache_row is None else cache_row[1]
    if prev is None:
        prev = torch.zeros((B, K - 1, xb.shape[-1]), dtype=xb.dtype,
                           device=xb.device)
    full = torch.cat([prev.to(xb.dtype), xb], dim=1)
    conv = full[:, :S] * lp.conv_w[0]
    for i in range(1, K):
        conv = conv + full[:, i:i + S] * lp.conv_w[i]
    xb_hi = wide(conv) + wide(lp.conv_b)
    xb = xb_hi.to(dt)
    new_conv = full[:, -(K - 1):]

    gates_a = xb @ lp.w_a
    gates_i = xb @ lp.w_i
    h0 = None if cache_row is None else cache_row[0]
    y, h_last = _rg_lru(xb_hi, gates_a, gates_i, lp.lam, h0, dtype=dt)
    out = (y * y_branch) @ lp.w_out
    s1 = wide(x) + wide(out)
    x = s1.to(dt)
    h2 = rms_norm(s1, lp.ln2).to(dt)
    s2 = wide(x) + wide(glu_mlp(h2, lp.m_gate, lp.m_up, lp.m_down, "gelu",
                                rules))
    new = None if cache_row is None else (h_last, new_conv)
    return s2.to(dt), s2, new


def _attn_sublayer(x, lp, cfg: ModelConfig, rules: ShardingRules, positions,
                   cache_row=None, angles=None):
    """One local-attention block (window ``cfg.window``) on the bf16
    stream a group starts from; cache_row: None or the (k (B, C, KV, hd),
    v, slot_pos (C,)) views of its rolling buffer, written in place.
    Returns (the bf16 stream, its fp32 sum)."""
    dt = x.dtype
    h = rms_norm(x, lp.ln).to(dt)
    q, k, v = attn.qkv_project(h, lp.wq, lp.wk, lp.wv, cfg, rules,
                               positions, angles)
    if cache_row is None:
        ctx = attn.attend(q, k, v, positions, positions, cfg, rules,
                          window=cfg.window)
    else:
        shard = attn.cache_shard()
        ck, cv, cpos = attn.cache_write(*cache_row, k, v, positions,
                                        cfg.window, shard)
        if positions.shape[0] > 1:
            # prefill-from-scratch: the rolling buffer only retains the last
            # W entries, but early queries need their own in-window keys —
            # attend over the fresh K/V (the window mask handles locality)
            ctx = attn.attend(q, k, v, positions, positions, cfg, rules,
                              window=cfg.window)
        else:
            ctx = attn.attend(q, ck, cv, positions, cpos, cfg, rules,
                              window=cfg.window, shard=shard)
    s1 = wide(x) + wide(attn.out_project(ctx, lp.wo, rules))
    x = s1.to(dt)
    h2 = rms_norm(s1, lp.ln2).to(dt)
    s2 = wide(x) + wide(glu_mlp(h2, lp.m_gate, lp.m_up, lp.m_down, "gelu",
                                rules))
    return s2.to(dt), s2


def forward(params, cfg: ModelConfig, rules: ShardingRules, tokens, positions,
            cache: Optional[HybridCache] = None, inputs_embeds=None):
    """tokens (B, S) int (ignored where ``inputs_embeds`` is given);
    positions (S,) absolute.  Returns (logits (B, S, V) fp32, the cache
    written in place with ``pos`` advanced by S, or None)."""
    lead, G = _layout(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = embed_tokens(tokens, params["embed"], rules,
                         scale=cfg.embed_scale, dtype=cfg.dtype)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def rec_row(i):
        return None if cache is None else (cache.state[i], cache.conv[i])

    def store(i, new):
        if new is not None:
            cache.state[i].copy_(new[0])
            cache.conv[i].copy_(new[1])

    x_hi = None
    leading = unbind_layers(params["lead"], lead) if lead else []
    for i, lp in enumerate(leading):
        x, x_hi, new = _rec_sublayer(x, lp, cfg, rules, rec_row(i), x_hi)
        store(i, new)

    def group(x, g, a, ra, rb):
        # one scan step of the reference: its carry enters in bf16, the
        # fp32 sums pass between its three layers
        row = None if cache is None else (cache.kv.k[g], cache.kv.v[g],
                                          cache.kv.slot_pos[g])
        x, hi = _attn_sublayer(x, a, cfg, rules, positions, row,
                               angles=angles)
        for j, lp in enumerate((ra, rb)):
            i = lead + 2 * g + j
            x, hi, new = _rec_sublayer(x, lp, cfg, rules, rec_row(i), hi)
            store(i, new)
        return x

    gp = params["groups"]
    cols = [unbind_layers(gp[n], G) for n in ("attn", "rec_a", "rec_b")]
    body = maybe_remat(group, cfg) if torch.is_grad_enabled() else group
    for g in range(G):
        x = body(x, g, *(c[g] for c in cols))
    x = rms_norm(x, params["final_norm"])
    logits = lm_head(x, params["embed"].T, cfg, rules)
    if cache is None:
        return logits, None
    return logits, cache._replace(pos=cache.pos + x.shape[1])


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device=None) -> HybridCache:
    """A zeroed cache on ``device`` (default the card; a missing card
    raises): the attention layers' rolling buffers of ``min(capacity,
    window)`` slots and the conv rows in ``dtype`` (default the config's),
    the RG-LRU states in fp32 (float64 for a float64 config)."""
    lead, G = _layout(cfg)
    n_rec, n_attn = lead + 2 * G, G
    R = cfg.rnn_width or cfg.d_model
    cap = min(capacity, cfg.window) if cfg.window else capacity
    dtype = dtype or cfg.dtype
    if device != "meta":
        device = resolve_device(device)
    return HybridCache(
        kv=attn.init_kv_cache(n_attn, batch, cap, cfg, dtype, device=device),
        state=torch.zeros((n_rec, batch, R), device=device,
                          dtype=wide(torch.empty((), dtype=cfg.dtype)).dtype),
        conv=torch.zeros((n_rec, batch, 3, R), dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def cache_specs(cfg: ModelConfig, rules: ShardingRules) -> HybridCache:
    """The cache's ``PartitionSpec``s under ``rules``."""
    bt = rules.resolve("batch")
    return HybridCache(
        kv=attn.cache_specs(rules),
        state=P(None, bt, rules.resolve("d_ff")),
        conv=P(None, bt, None, rules.resolve("d_ff")),
        pos=P())


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                 dtype=None) -> HybridCache:
    """``meta`` tensors of a cache's shapes (no allocation)."""
    return init_cache(cfg, batch, capacity, dtype, device="meta")
