"""Model registry (port of ``repro.models``): family dispatch for init and
the serving entry points.

* ``init_params(cfg, key, device=None)`` -> the reference's parameter
  tree of tensors on the device (default the card; a missing card
  raises), the model for serving and training alike;
* ``param_shapes(cfg)`` / ``count_params(cfg)``: ``meta`` tensors, no
  allocation; ``active_param_ratio(cfg)``;
* ``loss_fn(params, cfg, rules, batch)``: the teacher-forced
  cross-entropy, differentiable in ``params``;
* ``make_cache``, ``prefill_fn``, ``decode_fn``: the serving callables.

The ``dense`` and ``moe`` families are ported (one transformer,
``transformer.build_params``).  The others raise ``NotImplementedError``
naming their ROADMAP A slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..tree import tree_items, tree_leaves
from . import attention, transformer
from .common import InitBuilder, ModelConfig, ShapeBuilder, ShardingRules

# the families the port runs, all through ``transformer``
_PORTED = ("dense", "moe")
# family -> the ROADMAP A slice that ports it
_LATER = {"ssm": "slice 16d (repro.models.ssd)",
          "hybrid": "slice 16d (repro.models.rglru)",
          "encdec": "slice 16d (repro.models.encdec)",
          "vlm": "slice 16d (repro.models.vlm)"}


def _ported(cfg: ModelConfig) -> None:
    """Raises unless ``cfg``'s family is one the port runs."""
    fam = cfg.family
    if fam in _PORTED:
        return
    if fam in _LATER:
        raise NotImplementedError(
            f"the {fam!r} family ({cfg.arch}) is ROADMAP A, {_LATER[fam]}; "
            "repro_torch ports the dense and moe families so far")
    raise ValueError(fam)


def init_params(cfg: ModelConfig, key: int = 0,
                device=None) -> Dict[str, Any]:
    """A randomly initialized model from the int seed ``key``."""
    _ported(cfg)
    return transformer.build_params(cfg, InitBuilder(key, cfg.param_dtype,
                                                     device=device))


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree as ``meta`` tensors."""
    _ported(cfg)
    return transformer.build_params(cfg, ShapeBuilder(cfg.param_dtype))


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
    the valid tokens: fp32 ``logsumexp`` minus the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, rules: ShardingRules,
            batch: Dict[str, Any]):
    """Teacher-forced cross-entropy of ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S), a 0-dim fp32 tensor."""
    _ported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    logits, _ = transformer.forward(params, cfg, rules, tokens, positions)
    return _xent(logits, batch["labels"])


def make_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               shapes_only: bool = False, split_local_global: bool = False, device=None):
    """A zeroed KV cache in the config's dtype on ``device`` (default the
    card), or ``meta`` tensors with ``shapes_only``."""
    _ported(cfg)
    kw = {"dtype": cfg.dtype, "device": "meta" if shapes_only else device}
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


def prefill_fn(params, cfg: ModelConfig, rules: ShardingRules,
               batch: Dict[str, Any], cache):
    _ported(cfg)
    return transformer.prefill(params, cfg, rules, batch["tokens"], cache)


def decode_fn(params, cfg: ModelConfig, rules: ShardingRules, tokens, pos,
              cache):
    _ported(cfg)
    return transformer.decode_step(params, cfg, rules, tokens, pos, cache)


__all__ = ["ModelConfig", "ShardingRules", "active_param_ratio",
           "count_params", "decode_fn", "init_params", "loss_fn",
           "make_cache", "param_shapes", "prefill_fn"]
