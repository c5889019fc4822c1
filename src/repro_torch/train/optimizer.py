"""Optimizers over the reference's parameter trees (port of
``repro.train.optimizer``).

* ``AdamW``     — bf16 params + fp32 master/mu/nu; the params are re-cast
  from the fp32 master every step.
* ``Adafactor`` — the second moment factored over the last two dims of
  every leaf of rank >= 2 (a stacked ``(G, P, D)`` norm leaf included),
  the update clipped by its RMS over the whole leaf; optional first
  moment; updates in fp32, cast back to the param dtype.

A parameter tree is the reference's: nested dicts of tensors, layer
weights stacked ``(G, P, ...)``.  States are NamedTuples with the
reference's fields, so their ``keystr`` paths, and the checkpoints written
from them, are the reference's.  ``update`` computes the reference's
arithmetic op for op in fp32 and writes the new values into the state's
and the params' tensors in place (the buffers a jitted step would donate),
returning them; the gradients are read only.  ``state_shapes`` gives
``meta`` tensors, ``state_specs`` the state's ``PartitionSpec``s from the
params' (each moment placed like its param; Adafactor's factored moments
drop the reduced dim's entry).

Sharded, the update runs on each rank's local shards (the state built by
``init`` on the params' shards is the shard of the state ``state_specs``
places): AdamW is elementwise; Adafactor's row and column means and its
RMS over a leaf are sums over the ranks that split the reduced dims,
given by ``update(..., means=)`` (a tree of
``distributed.sharded.LeafMeans`` of the params' structure).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..models.common import P
from ..tree import tree_leaves, tree_map


def _device(tree):
    return tree_leaves(tree)[0].device


# -- schedules ---------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    """Linear warm-up, then cosine decay to ``min_ratio * base_lr``; the
    learning rate of ``step`` as a 0-dim fp32 tensor, computed in fp32."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


# -- AdamW -------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor
    master: Any   # fp32 copy of params
    mu: Any
    nu: Any


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            master=tree_map(lambda p: p.detach().to(torch.float32,
                                                    copy=True), params),
            mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params),
            nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params))

    def state_shapes(self, param_shapes) -> AdamWState:
        f32 = lambda p: _meta(p.shape)
        return AdamWState(step=_meta((), torch.int32),
                          master=tree_map(f32, param_shapes),
                          mu=tree_map(f32, param_shapes),
                          nu=tree_map(f32, param_shapes))

    def state_specs(self, param_specs) -> AdamWState:
        return AdamWState(step=P(), master=param_specs, mu=param_specs,
                          nu=param_specs)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr, means=None):
        """``means`` is accepted for the sharded step's sake: AdamW's update
        is elementwise, so a shard updates alone."""
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t

        def upd(g, m, v, w, p):
            g = g.to(torch.float32)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / c1).div_(torch.sqrt(v / c2).add_(self.eps))
            w.sub_(u.add_(self.weight_decay * w).mul_(lr))
            p.copy_(w)

        tree_map(upd, grads, state.mu, state.nu, state.master, params)
        return params, AdamWState(step=step, master=state.master,
                                  mu=state.mu, nu=state.nu)


# -- Adafactor ---------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor
    v_row: Any
    v_col: Any
    v_full: Any   # for rank-<2 params
    mu: Any       # (1,) zeros when beta1 is None


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Shazeer & Stern 2018; factored for every rank>=2 param over its last
    two dims.  ``beta1=None`` disables the first moment (the memory saver)."""
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    beta1: Optional[float] = None
    weight_decay: float = 0.0

    @staticmethod
    def _shapes(shape, beta1):
        """(v_row, v_col, v_full, mu) shapes of a param of ``shape``."""
        shape = tuple(shape)
        fac = len(shape) >= 2
        return (shape[:-1] if fac else (1,),
                shape[:-2] + shape[-1:] if fac else (1,),
                (1,) if fac else shape,
                shape if beta1 is not None else (1,))

    def _parts(self, params, make):
        """(v_row, v_col, v_full, mu) trees, ``make(shape, param)`` a leaf."""
        return tuple(tree_map(lambda p, i=i: make(
            self._shapes(p.shape, self.beta1)[i], p), params)
            for i in range(4))

    def init(self, params) -> AdafactorState:
        return AdafactorState(
            torch.zeros((), dtype=torch.int32, device=_device(params)),
            *self._parts(params, lambda shape, p: torch.zeros(
                shape, dtype=torch.float32, device=p.device)))

    def state_shapes(self, param_shapes) -> AdafactorState:
        return AdafactorState(_meta((), torch.int32), *self._parts(
            param_shapes, lambda shape, p: _meta(shape)))

    def state_specs(self, param_specs) -> AdafactorState:
        def vrow(s):
            return P(*s[:-1]) if len(s) >= 2 else P(None)

        def vcol(s):
            return P(*(tuple(s[:-2]) + (s[-1],))) if len(s) >= 2 else P(None)

        def vfull(s):
            return P(None) if len(s) >= 2 else P(*s)

        def mu(s):
            return P(*s) if self.beta1 is not None else P(None)

        return AdafactorState(step=P(), v_row=tree_map(vrow, param_specs),
                              v_col=tree_map(vcol, param_specs),
                              v_full=tree_map(vfull, param_specs),
                              mu=tree_map(mu, param_specs))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params, lr, means=None):
        """``means``: None (the whole leaf is here) or a tree of
        ``LeafMeans`` (the leaf's means sum over the ranks that split
        it)."""
        step = state.step + 1
        t = step.to(torch.float32)
        rho = 1.0 - t ** (-self.decay)

        def upd(g, vr, vc, vf, m, p, red=None):
            if red is None:
                mean = lambda x, dim, pdim, keepdim=False: x.mean(
                    dim=dim, keepdim=keepdim)
                mean_all = torch.mean
            else:
                mean, mean_all = red.mean, red.mean_all
            g = g.to(torch.float32)
            g2 = g * g + self.eps
            if g.ndim >= 2:
                vr.mul_(rho).add_((1 - rho) * mean(g2, -1, -1))
                vc.mul_(rho).add_((1 - rho) * mean(g2, -2, -2))
                r = vr / torch.clamp(mean(vr, -1, -2, keepdim=True),
                                     min=self.eps)
                u = g / torch.sqrt(r[..., :, None] * vc[..., None, :])
            else:
                vf.mul_(rho).add_((1 - rho) * g2)
                u = g / torch.sqrt(vf)
            rms = torch.sqrt(mean_all(u * u))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.beta1 is not None:
                m.mul_(self.beta1).add_((1 - self.beta1) * u)
                u = m
            w32 = p.to(torch.float32)
            p.copy_(w32 - lr * (u + self.weight_decay * w32))

        rest = () if means is None else (means,)
        tree_map(upd, grads, state.v_row, state.v_col, state.v_full,
                 state.mu, params, *rest)
        return params, AdafactorState(step=step, v_row=state.v_row,
                                      v_col=state.v_col,
                                      v_full=state.v_full, mu=state.mu)


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(name)
