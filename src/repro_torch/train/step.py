"""train_step / serve_step factories (port of ``repro.train.step``).

``make_train_step`` returns ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)`` over the reference's parameter tree: the gradients
come from autograd (``torch.autograd.grad``, never ``.grad``), with
optional micro-batch accumulation (the micro-batches' gradients summed
into fp32 zeros, as the reference's scan does) and optional bf16 gradient
compression (the cast the data-parallel path puts on the wire).  The
optimizer writes the new values into the params' and the state's tensors
(see ``optimizer``).  ``metrics`` holds 0-dim tensors, so a step makes no
host read.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import models as M
from ..models.common import ModelConfig, ShardingRules
from ..tree import tree_leaves, tree_map
from .optimizer import cosine_schedule, get_optimizer


def make_loss(cfg: ModelConfig, rules: ShardingRules):
    def loss(params, batch):
        return M.loss_fn(params, cfg, rules, batch)
    return loss


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``: the tree's tensors are
    differentiated through views that share their storage."""
    xs = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(xs, batch)
    leaves = tree_leaves(xs)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], xs)


def make_train_step(cfg: ModelConfig, rules: ShardingRules, optimizer,
                    lr_fn: Callable, accum_steps: int = 1,
                    compress_grads: Optional[str] = None):
    if compress_grads not in (None, "bf16"):
        raise ValueError(f"compress_grads={compress_grads!r}: None | 'bf16'")
    loss_fn = make_loss(cfg, rules)

    def train_step(params, opt_state, batch, step):
        if accum_steps == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"accum_steps={accum_steps}")
            mb = B // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = _value_and_grad(loss_fn, params, micro)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(accum_steps), grads)
            loss = loss / accum_steps
        if compress_grads == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16)
                             .to(torch.float32), grads)
        lr = torch.as_tensor(lr_fn(step), dtype=torch.float32)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules):
    def prefill_step(params, batch, cache):
        logits, cache = M.prefill_fn(params, cfg, rules, batch, cache)
        # next-token for the serving loop
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: ShardingRules):
    def decode_step(params, tokens, pos, cache):
        logits, cache = M.decode_fn(params, cfg, rules, tokens, pos, cache)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), cache
    return decode_step


def default_optimizer(cfg: ModelConfig):
    """arctic-class models: adafactor (fp32 params, factored vs); else adamw."""
    if M.count_params(cfg) > 100e9:
        return get_optimizer("adafactor")
    return get_optimizer("adamw")


def default_lr(cfg: ModelConfig, total_steps: int = 10000):
    return cosine_schedule(3e-4, warmup=min(500, total_steps // 10),
                           total=total_steps)
