"""Mamba-2 / SSD (state-space duality) blocks, arXiv:2405.21060 (port of
``repro.models.ssd``).

The full forward (training, and any call without a cache) runs the
chunked SSD algorithm, ``ssd_chunked``: an intra-chunk quadratic term and
an inter-chunk recurrence over the chunks' states, O(S l) work for chunk
l, never an (S, S) matrix.  A call with a cache (prefill and decode alike,
as in the reference) steps the O(1)-state recurrence token by token.  The
two compute one function; the port's tests hold them together.

``ssd_chunked``'s four einsums are written as explicit products, so no
intermediate outgrows the operands:

1. the diagonal blocks: ``C Bᵀ`` (l × l a chunk), times the decay mask
   ``L`` (h × l × l), then the product with x over j;
2. each chunk's state: x scaled by its decay to the chunk's end, then the
   product with B over the chunk's l positions;
3. the inter-chunk recurrence, a loop over the chunks;
4. the states' output: ``C`` times the carried states over n, then scaled
   by the decay from the chunk's start.

Numerics follow the reference's compiled graph (XLA on the CPU, read from
``jax.jit(...).lower(...).compile().as_text()`` of ``_ssm_sublayer`` and
``ssd_chunked``), bf16 where the reference's arrays are bf16:

* the projection ``zxbcdt`` is rounded to bf16; the causal conv runs op by
  op in bf16 (each product, each of the four partial sums, the bias, and
  silu's negation, exponential, sum and quotient each rounded);
* ``dt = softplus(dt + dt_bias)`` runs in fp32 as ``logaddexp(x, 0)``,
  max(x, 0) + log1p(exp(-|x|)) (``F.softplus`` switches to the identity
  above 20, which is another function); ``xdt = xs * bf16(dt)`` is bf16;
* ``ssd_chunked`` and the recurrence run in fp32 on the bf16 inputs
  upcast; the carried inter-chunk states are rounded to bf16 before their
  output product (``prev_states.astype(x.dtype)``);
* ``y`` is rounded to bf16, then ``y + xs * Dskip`` (the product rounded)
  is rounded again;
* the gate's product ``y * silu(z)`` keeps fp32 into ``rms_norm`` (the
  compiled graph drops that rounding; silu itself is op by op in bf16),
  and its cotangent is rounded to bf16 in the backward (``_Gate``);
  the norm's output and ``out_proj``'s product are bf16, and the residual
  sum is rounded to bf16 after each layer (a layer is one step of the
  reference's scan, its carry bf16);
* the tied head's product is rounded to bf16 before its fp32 upcast
  (``common.lm_head``).

The working dtype of the scan is the inputs', fp32 at least: the
reference hard-codes fp32, and the port keeps float64 for a float64
config (``common.wide``), which the card's gradient witness evaluates.
The conv cache is held in the config's dtype (bf16 in every published
config, the reference's ``init_cache``; the reference's returned cache
carries ``xBC``'s dtype, so an fp32 config's is fp32 after one call), the
state in the working dtype.  Caches are written in place.

Each layer is rematerialized alone under ``cfg.remat`` (the reference's
``maybe_remat`` over its single-layer scan body).  ``cache_specs`` gives
the cache's ``PartitionSpec``s under a ``ShardingRules``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..device import resolve_device
from .common import (P, Builder, ModelConfig, ShardingRules, _act, _Softplus,
                     embed_tokens, lm_head, maybe_remat, rms_norm,
                     unbind_layers, wide)

_silu = _act("silu")


class SSMCache(NamedTuple):
    state: torch.Tensor   # (L, B, H, P, N) recurrent state
    conv: torch.Tensor    # (L, B, K-1, conv_dim) rolling conv input
    pos: torch.Tensor     # () int32


def _segsum(x):
    """x (..., l) -> (..., l, l) lower-triangular segment sums
    (cs[i] - cs[j] for j <= i, -inf above the diagonal)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, float("-inf"))


def _work_dtype(*ts):
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def ssd_chunked(x, dtA, B_, C_, chunk: int):
    """x (b, s, h, p); dtA (b, s, h); B_, C_ (b, s, n) (one group).
    Returns y (b, s, h, p) and the final state (b, h, p, n), both in the
    working dtype (fp32, or float64 when an input is).  The chunk length is
    ``chunk``, shrunk until it divides s (the reference's rule)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    l = min(chunk, s)
    while s % l:
        l -= 1
    nc = s // l
    wd = _work_dtype(x, dtA, B_, C_)

    def up(t):
        # each product widens its own operands, as each of the reference's
        # einsums promotes its own: an operand's cotangents are rounded
        # back to its dtype product by product, then summed
        return t.to(wd)

    xr = x.reshape(b, nc, l, h, p)
    Ar = up(dtA.reshape(b, nc, l, h))
    Br = B_.reshape(b, nc, l, n)
    Cr = C_.reshape(b, nc, l, n)

    Acs = torch.cumsum(Ar, dim=2)                                 # (b,nc,l,h)
    # 1. intra-chunk (diagonal blocks): (C Bᵀ) ⊙ L, then times x over j
    L = torch.exp(_segsum(Ar.movedim(3, 2)))                      # (b,nc,h,l,l)
    CB = up(Cr) @ up(Br).transpose(-1, -2)                        # (b,nc,l,l)
    Ydiag = (L * CB[:, :, None]) @ up(xr).permute(0, 1, 3, 2, 4)  # (b,nc,h,l,p)
    # 2. per-chunk output states: x decayed to the chunk's end, times B
    decay = torch.exp(Acs[:, :, -1:, :] - Acs)                    # (b,nc,l,h)
    dx = (up(xr) * decay[..., None]).permute(0, 1, 3, 4, 2)       # (b,nc,h,p,l)
    states = dx @ up(Br)[:, :, None]                              # (b,nc,h,p,n)
    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(Acs[:, :, -1, :])                     # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=wd, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = up(torch.stack(prev, dim=1).to(x.dtype))       # (b,nc,h,p,n)
    # 4. state -> output: C times the entering state over n, then its decay
    state_decay = torch.exp(Acs)                                  # (b,nc,l,h)
    Cs = up(Cr)[:, :, None] @ prev_states.transpose(-1, -2)       # (b,nc,h,l,p)
    Yoff = Cs.permute(0, 1, 3, 2, 4) * state_decay[..., None]     # (b,nc,l,h,p)
    y = Ydiag.permute(0, 1, 3, 2, 4) + Yoff
    return y.reshape(b, s, h, p), carry


def _ssd_recurrent(xdt, dtA, B_, C_, state):
    """The O(1)-state recurrence over the S tokens of xdt (B, S, H, P),
    dtA (B, S, H), B_, C_ (B, S, N) from ``state`` (B, H, P, N): state ←
    state · exp(dtA) + x ⊗ B, y = state · C, in the working dtype.
    Returns (y (B, S, H, P), the last state)."""
    wd = _work_dtype(xdt, dtA, B_, C_, state)
    st = state.to(wd)
    xw, Bw, Cw = xdt.to(wd), B_.to(wd), C_.to(wd)
    dA = torch.exp(dtA.to(wd))
    ys = []
    for t in range(xdt.shape[1]):
        st = st * dA[:, t, :, None, None] \
            + xw[:, t, :, :, None] * Bw[:, t, None, None, :]
        ys.append(st @ Cw[:, t, None, :, None])                  # (B,H,P,1)
    return torch.stack(ys, dim=1)[..., 0], st


def _conv_dim(cfg: ModelConfig):
    return cfg.d_inner + 2 * cfg.ssm_state


def build_params(cfg: ModelConfig, b: Builder) -> Dict[str, Any]:
    """The reference's parameter tree, built by ``b``: layer leaves
    stacked ``(L, ...)``, the embedding tied to the head."""
    L = cfg.num_layers
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = 2 * DI + 2 * N + H          # z, x, B, C, dt
    cdim = _conv_dim(cfg)
    lp = {
        "ln": b("ln", (L, D), (None, None), init="zeros"),
        "in_proj": b("in_proj", (L, D, proj), (None, "fsdp", None)),
        "conv_w": b("conv_w", (L, cfg.ssm_conv, cdim), (None, None, None)),
        "conv_b": b("conv_b", (L, cdim), (None, None), init="zeros"),
        "dt_bias": b("dt_bias", (L, H), (None, None), init="zeros"),
        "A_log": b("A_log", (L, H), (None, None), init="zeros"),
        "Dskip": b("Dskip", (L, H), (None, None), init="ones"),
        "gate_ln": b("gate_ln", (L, DI), (None, None), init="zeros"),
        "out_proj": b("out_proj", (L, DI, D), (None, None, "fsdp")),
    }
    return {
        "embed": b("embed", (cfg.vocab_size, D), ("vocab", "fsdp")),
        "final_norm": b("final_norm", (D,), (None,), init="zeros"),
        "layers": lp,
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :DI]
    xBC = zxbcdt[..., DI:DI + DI + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, w, bias, prev: Optional[torch.Tensor]):
    """Depthwise causal conv along the sequence, op by op in xBC's dtype.
    xBC (B, S, Cd); w (K, Cd); prev (B, K-1, Cd) left context (a cache) or
    None (zeros).  Returns (silu(conv + bias), the last K-1 inputs)."""
    K, S = w.shape[0], xBC.shape[1]
    if prev is None:
        prev = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                           dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([prev.to(xBC.dtype), xBC], dim=1)        # (B,S+K-1,Cd)
    out = full[:, :S] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * w[i]
    return _silu(out + bias), full[:, -(K - 1):]


class _Gate(torch.autograd.Function):
    """``y * silu(z)`` as the reference's compiled graph computes it: the
    bf16 product's rounding is dropped in the forward (its fp32 value goes
    into the norm), while its cotangent is rounded to bf16 and each
    operand's gradient is a bf16 product of it."""

    @staticmethod
    def forward(ctx, y, s):
        ctx.save_for_backward(y, s)
        return wide(y) * wide(s)

    @staticmethod
    def backward(ctx, g):
        y, s = ctx.saved_tensors
        g = g.to(y.dtype)
        return g * s, g * y


def _ssm_sublayer(x, lp, cfg: ModelConfig, rules: ShardingRules,
                  cache_row=None):
    """One mamba2 block on x (B, S, D); ``lp`` the layer's weights by
    name.  cache_row: None (the chunked scan) or (state (B, H, P, N), conv
    (B, K-1, Cd)) (the recurrence from them).  Returns (x + the block's
    output, (new state, new conv) or None)."""
    B, S, _ = x.shape
    H, P, N, DI = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    dt_ = x.dtype
    h = rms_norm(x, lp.ln)
    z, xBC, dt = _split_proj(h @ lp.in_proj, cfg)
    xBC, new_conv = _causal_conv(xBC, lp.conv_w, lp.conv_b,
                                 None if cache_row is None else cache_row[1])
    xs = xBC[..., :DI].reshape(B, S, H, P)
    B_ = xBC[..., DI:DI + N]
    C_ = xBC[..., DI + N:]
    dt = _Softplus.apply(wide(dt) + wide(lp.dt_bias))
    A = -torch.exp(wide(lp.A_log))                                # (H,)
    dtA = dt * A                                                  # (B,S,H)
    xdt = xs * dt.to(xs.dtype)[..., None]

    if cache_row is None:
        y, new_state = ssd_chunked(xdt, dtA, B_, C_, cfg.ssm_chunk)
    else:
        y, new_state = _ssd_recurrent(xdt, dtA, B_, C_, cache_row[0])

    y = y.to(dt_) + xs * lp.Dskip.to(xs.dtype)[:, None]
    y = _Gate.apply(y.reshape(B, S, DI), _silu(z))
    y = rms_norm(y, lp.gate_ln).to(dt_)
    out = (y @ lp.out_proj).to(dt_)
    return x + out, (None if cache_row is None else (new_state, new_conv))


def forward(params, cfg: ModelConfig, rules: ShardingRules, tokens,
            positions=None, cache: Optional[SSMCache] = None,
            inputs_embeds=None):
    """tokens (B, S) int (ignored where ``inputs_embeds`` is given);
    ``positions`` is taken for the reference's signature and not read.
    Without a cache the layers run the chunked scan (autograd reaches the
    parameter tree's leaves); with one they step the recurrence from it
    and write the new state and conv rows into it in place.  Returns
    (logits (B, S, V) fp32, the cache with ``pos`` advanced by S, or
    None)."""
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = embed_tokens(tokens, params["embed"], rules,
                         scale=cfg.embed_scale, dtype=cfg.dtype)

    def layer(x, lp, row):
        return _ssm_sublayer(x, lp, cfg, rules, row)

    body = maybe_remat(layer, cfg) if torch.is_grad_enabled() else layer
    for l, lp in enumerate(unbind_layers(params["layers"], cfg.num_layers)):
        row = None if cache is None else (cache.state[l], cache.conv[l])
        x, new = body(x, lp, row)
        if cache is not None:
            cache.state[l].copy_(new[0])
            cache.conv[l].copy_(new[1])
    x = rms_norm(x, params["final_norm"])
    logits = lm_head(x, params["embed"].T, cfg, rules)
    if cache is None:
        return logits, None
    return logits, cache._replace(pos=cache.pos + x.shape[1])


def init_cache(cfg: ModelConfig, batch: int, dtype=None,
               device=None) -> SSMCache:
    """A zeroed cache on ``device`` (default the card; a missing card
    raises): the state in ``dtype`` (default fp32, float64 for a float64
    config), the conv rows in the config's dtype."""
    L, H, P, N = cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if dtype is None:
        dtype = wide(torch.empty((), dtype=cfg.dtype)).dtype
    if device != "meta":
        device = resolve_device(device)
    return SSMCache(
        state=torch.zeros((L, batch, H, P, N), dtype=dtype, device=device),
        conv=torch.zeros((L, batch, cfg.ssm_conv - 1, _conv_dim(cfg)),
                         dtype=cfg.dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def cache_specs(rules: ShardingRules) -> SSMCache:
    """The cache's ``PartitionSpec``s under ``rules``."""
    return SSMCache(
        state=P(None, rules.resolve("batch"), None, None, rules.state),
        conv=P(None, rules.resolve("batch"), None, None),
        pos=P())


def cache_shapes(cfg: ModelConfig, batch: int, dtype=None) -> SSMCache:
    """``meta`` tensors of a cache's shapes (no allocation)."""
    return init_cache(cfg, batch, dtype, device="meta")
