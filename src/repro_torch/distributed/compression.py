"""Gradient compression for the data-parallel training path (port of
``repro.distributed.compression``).

* ``bf16``: a bf16 cast before the cross-replica mean — half the
  all-reduce bytes; fp32 after.
* ``int8_ef``: int8 quantization with **error feedback** (Seide et al. /
  1-bit Adam lineage): the quantization residual is carried to the next
  step so the compressed SGD stays unbiased in the long run.

The reference runs these around ``psum`` over a named mesh axis inside
``shard_map``; here they run over a ``torch.distributed`` process group
(``None``: the default group; the group of a ``DeviceMesh`` dimension is
``mesh.get_group(axis)``).  A gradient tree is nested dicts of tensors.
The all-reduce runs where the tensor lies under NCCL and through host
memory under any other backend (gloo), as ``core.distributed``'s
collectives do; gloo sums bf16 as bf16, so the bf16 payload travels as
it does in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..tree import tree_map


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group``, in ``t``'s
    dtype, on ``t``'s device (``t`` is not modified)."""
    staged = t.is_cuda and "nccl" not in str(dist.get_backend(group))
    buf = t.detach().to("cpu" if staged else t.device, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def psum_bf16(grads, group=None):
    """bf16-compressed cross-replica mean: the bf16 sum over the group
    divided by its size in bf16, returned in fp32."""
    n = dist.get_world_size(group)

    def one(g):
        return (_all_reduce_sum(g.to(torch.bfloat16), group) / n).to(
            torch.float32)
    return tree_map(one, grads)


def quantize_int8(g) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def psum_int8_ef(grads, errors, group=None):
    """int8 + error-feedback cross-replica mean.

    Returns (decompressed mean grads, new error residuals).  The sum runs
    over the dequantized fp32 payload, as the reference's ``psum`` does
    (its wire format is int8 + scale; int8 tensors sum exactly)."""
    n = float(dist.get_world_size(group))

    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale = quantize_int8(g)
        deq = dequantize_int8(q, scale)
        return _all_reduce_sum(deq, group) / n, g - deq
    out = tree_map(one, grads, errors)       # (mean, residual) leaves
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
