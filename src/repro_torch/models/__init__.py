"""Model registry (port of ``repro.models``): family dispatch for init and
the serving entry points.

* ``init_params(cfg, key, device=None)`` -> the reference's parameter
  tree of tensors on the device (default the card; a missing card
  raises), the model for serving and training alike;
* ``param_shapes(cfg)`` / ``count_params(cfg)``: ``meta`` tensors, no
  allocation; ``active_param_ratio(cfg)``; ``param_specs(cfg, rules)``
  and ``cache_specs(cfg, rules)``: the reference's ``PartitionSpec``
  trees (``launch.sharding`` places them over a ``DeviceMesh``);
* ``loss_fn(params, cfg, rules, batch)``: the teacher-forced
  cross-entropy, differentiable in ``params``;
* ``make_cache``, ``prefill_fn``, ``decode_fn``: the serving callables.

Every family of the reference is ported: ``dense`` and ``moe`` (one
transformer, ``transformer.build_params``), ``vlm`` (the transformer
behind projected patch embeddings, ``vlm``), ``ssm`` (mamba2, ``ssd``),
``hybrid`` (recurrentgemma, ``rglru``) and ``encdec`` (seamless,
``encdec``).  An unknown family raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..tree import tree_items, tree_leaves
from . import attention, encdec, rglru, ssd, transformer, vlm
from .common import (InitBuilder, ModelConfig, ShapeBuilder, ShardingRules,
                     SpecBuilder, vocab_nll)

# the families the port runs, by their parameter builders
_BUILDERS = {
    "dense": transformer.build_params,
    "moe": transformer.build_params,
    "vlm": vlm.build_params,
    "ssm": ssd.build_params,
    "hybrid": rglru.build_params,
    "encdec": encdec.build_params,
}


def _ported(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` unless ``cfg``'s family is one the port
    runs."""
    if cfg.family not in _BUILDERS:
        raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, key: int = 0,
                device=None) -> Dict[str, Any]:
    """A randomly initialized model from the int seed ``key``."""
    _ported(cfg)
    return _BUILDERS[cfg.family](cfg, InitBuilder(key, cfg.param_dtype,
                                                  device=device))


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree as ``meta`` tensors."""
    _ported(cfg)
    return _BUILDERS[cfg.family](cfg, ShapeBuilder(cfg.param_dtype))


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, Any]:
    """The parameter tree's ``PartitionSpec``s under ``rules``."""
    _ported(cfg)
    return _BUILDERS[cfg.family](cfg, SpecBuilder(rules))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(t.numel() for t in tree_leaves(param_shapes(cfg))))


def active_param_ratio(cfg: ModelConfig) -> float:
    """active / total params (the reference's MoE top-k accounting: an
    expert leaf counts topk / E of its size); 1.0 for a dense model."""
    if cfg.num_experts == 0:
        return 1.0
    total = active = 0
    for name, leaf in tree_items(param_shapes(cfg)):
        n = leaf.numel()
        total += n
        if any(t in name for t in ("e_gate", "e_up", "e_down")):
            active += n * cfg.num_experts_per_tok / cfg.num_experts
        else:
            active += n
    return active / total


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _xent(logits, labels, mask=None):
    """logits (B, S, V) fp32, labels (B, S) int.  Mean cross-entropy over
    the valid tokens: fp32 ``logsumexp`` minus the gold logit (under a
    tensor-parallel vocab, ``common.vocab_nll`` over this rank's columns
    of the logits and the other ranks')."""
    nll = vocab_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, rules: ShardingRules,
            batch: Dict[str, Any]):
    """Teacher-forced cross-entropy of ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S), a 0-dim fp32 tensor (vlm: the logits of
    the text positions only, after ``batch["patch_embeds"]``' P; encdec:
    ``batch["frames"]`` encoded, ``batch["dec_tokens"]`` decoded)."""
    _ported(cfg)
    if cfg.family == "encdec":
        logits, _ = encdec.forward_train(params, cfg, rules, batch["frames"],
                                         batch["dec_tokens"])
        return _xent(logits, batch["labels"])
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        logits, _ = vlm.forward_train(params, cfg, rules, tokens,
                                      batch["patch_embeds"])
        # patches carry no labels
        P = batch["patch_embeds"].shape[1]
        return _xent(logits[:, P:], batch["labels"])
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    fwd = {"ssm": ssd.forward, "hybrid": rglru.forward}.get(
        cfg.family, transformer.forward)
    logits, _ = fwd(params, cfg, rules, tokens, positions)
    return _xent(logits, batch["labels"])


def make_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               shapes_only: bool = False, t_enc: int = 0,
               split_local_global: bool = False, device=None):
    """A zeroed cache on ``device`` (default the card), or ``meta``
    tensors with ``shapes_only``: the KV cache in the config's dtype (an
    ssm model's ``ssd.SSMCache``, whose state does not grow, ignores
    ``capacity``; a hybrid model's ``rglru.HybridCache`` caps it at the
    window; an encdec model's ``encdec.EncDecCache`` also holds the cross
    K/V of ``t_enc`` frames)."""
    _ported(cfg)
    at = "meta" if shapes_only else device
    if cfg.family == "ssm":
        return ssd.init_cache(cfg, batch, device=at)
    if cfg.family == "hybrid":
        return rglru.init_cache(cfg, batch, capacity, device=at)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, capacity, t_enc, device=at)
    kw = {"dtype": cfg.dtype, "device": at}
    if (split_local_global and cfg.local_global_period == 2
            and capacity > cfg.window > 0):
        # gemma2 long context: local layers hold window-sized ring buffers,
        # only global layers hold full KV
        G = cfg.num_layers // 2
        return {"local": attention.init_kv_cache(G, batch, cfg.window, cfg,
                                                 **kw),
                "global": attention.init_kv_cache(G, batch, capacity, cfg,
                                                  **kw)}
    cap = capacity
    if cfg.window and not cfg.local_global_period:
        cap = min(capacity, cfg.window)
    return attention.init_kv_cache(cfg.num_layers, batch, cap, cfg, **kw)


def cache_specs(cfg: ModelConfig, rules: ShardingRules):
    """The cache's ``PartitionSpec``s under ``rules``, in the structure of
    ``make_cache``'s (one tree for gemma2's split local/global caches)."""
    _ported(cfg)
    if cfg.family == "ssm":
        return ssd.cache_specs(rules)
    if cfg.family == "hybrid":
        return rglru.cache_specs(cfg, rules)
    if cfg.family == "encdec":
        return encdec.cache_specs(rules)
    return attention.cache_specs(rules)


def prefill_fn(params, cfg: ModelConfig, rules: ShardingRules,
               batch: Dict[str, Any], cache):
    """``batch["tokens"]`` (and a vlm's ``batch["patch_embeds"]``, before
    them) written into ``cache``; an ssm model steps its recurrence over
    the prompt, as the reference does; an encdec model encodes
    ``batch["frames"]`` and prefills ``batch["dec_tokens"]``."""
    _ported(cfg)
    if cfg.family == "encdec":
        return encdec.prefill(params, cfg, rules, batch["frames"],
                              batch["dec_tokens"], cache)
    if cfg.family == "hybrid":
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        with torch.no_grad():
            return rglru.forward(params, cfg, rules, tokens, positions,
                                 cache=cache)
    if cfg.family == "vlm":
        return vlm.prefill(params, cfg, rules, batch["tokens"],
                           batch["patch_embeds"], cache)
    if cfg.family == "ssm":
        with torch.no_grad():
            return ssd.forward(params, cfg, rules, batch["tokens"],
                               cache=cache)
    return transformer.prefill(params, cfg, rules, batch["tokens"], cache)


def decode_fn(params, cfg: ModelConfig, rules: ShardingRules, tokens, pos,
              cache):
    """One step of ``tokens`` (B, 1) at position ``pos`` (an int, or a
    tensor on the tokens' device; an ssm model's recurrence does not read
    it)."""
    _ported(cfg)
    if cfg.family == "ssm":
        with torch.no_grad():
            return ssd.forward(params, cfg, rules, tokens, cache=cache)
    if cfg.family == "hybrid":
        positions = torch.as_tensor(pos, dtype=torch.int32,
                                    device=tokens.device).reshape(1)
        with torch.no_grad():
            return rglru.forward(params, cfg, rules, tokens, positions,
                                 cache=cache)
    if cfg.family == "encdec":
        return encdec.decode_step(params, cfg, rules, tokens, pos, cache)
    return transformer.decode_step(params, cfg, rules, tokens, pos, cache)


__all__ = ["ModelConfig", "ShardingRules", "active_param_ratio",
           "cache_specs", "count_params", "decode_fn", "init_params",
           "loss_fn", "make_cache", "param_shapes", "param_specs",
           "prefill_fn"]
