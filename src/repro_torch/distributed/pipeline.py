"""GPipe-style pipeline parallelism over a mesh dimension (port of
``repro.distributed.pipeline``).

``pipeline_apply`` runs a stack of per-stage functions over the ``axis``
dimension of a ``torch.distributed`` ``DeviceMesh``, one rank a stage,
with the classic (num_micro + S - 1)-slot schedule: in every slot each
stage runs its function on the micro-batch it holds, then the
activations ring-shift to the next stage (``dist.batch_isend_irecv``,
where the reference uses ``ppermute``); the last stage banks the finished
micro-batches, and at the end its outputs reach every rank of the axis.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..device import is_dtensor
from ..tree import tree_map


def _stage_row(leaf, sid: int):
    """This stage's slice of a leaf with a leading stage dim: the local row
    of a DTensor sharded over the axis, else row ``sid`` of the stack."""
    if is_dtensor(leaf):
        return leaf.to_local()[0]
    return leaf[sid]


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def _ring_shift(y: torch.Tensor, group, sid: int, S: int) -> torch.Tensor:
    """``y`` of stage ``sid`` sent to stage ``sid + 1`` (mod S); returns what
    stage ``sid - 1`` sent here."""
    staged = _host_staged(y, group)
    send = y.detach().to("cpu" if staged else y.device).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (sid + 1) % S), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (sid - 1) % S), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(y.device)


def pipeline_apply(stage_fn: Callable, stage_params, x, mesh,
                   axis: str = "pod", num_micro: int = 4):
    """Run ``y = stage_{S-1}(...stage_0(x))`` pipelined over ``axis``.

    stage_fn(params_slice, xb) -> yb — one stage's computation on one
    micro-batch (all stages share this callable; per-stage behaviour comes
    from ``stage_params``, a tree whose leaves carry a leading stage dim:
    the whole (S, ...) stack, or a DTensor sharded over ``axis``).

    x: (B, ...) with B % num_micro == 0, the same on every rank of the
    axis; returns the same shape on every rank.  A forward pass: the
    point-to-point transfers carry no gradient (the reference's
    ``ppermute`` has a transpose; a backward schedule is not ported)."""
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    B = x.shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} is not a multiple of "
                         f"num_micro={num_micro}")
    mb = B // num_micro
    params = tree_map(lambda p: _stage_row(p, sid), stage_params)
    micro = x.reshape((num_micro, mb) + tuple(x.shape[1:]))
    out = torch.zeros_like(micro)
    carry = torch.zeros((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    for t in range(num_micro + S - 1):
        # stage 0 ingests micro-batch t; stage s works on t - s when in range
        xin = micro[min(t, num_micro - 1)] if sid == 0 else carry
        y = stage_fn(params, xin) if 0 <= t - sid < num_micro else carry
        if sid == S - 1 and t >= S - 1:
            out[t - (S - 1)] = y
        carry = _ring_shift(y, group, sid, S) if S > 1 else y
    # only the last stage holds real outputs: broadcast them
    if S > 1:
        staged = _host_staged(out, group)
        buf = out.to("cpu") if staged else out
        dist.broadcast(buf, src=dist.get_global_rank(group, S - 1),
                       group=group)
        out = buf.to(x.device)
    return out.reshape(x.shape)
