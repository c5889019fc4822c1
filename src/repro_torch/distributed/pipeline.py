"""GPipe-style pipeline parallelism over a mesh dimension (port of
``repro.distributed.pipeline``).

``pipeline_apply`` runs a stack of per-stage functions over the ``axis``
dimension of a ``torch.distributed`` ``DeviceMesh``, one rank a stage,
with the classic (num_micro + S - 1)-slot schedule: in every slot each
stage runs its function on the micro-batch it holds, then the
activations ring-shift to the next stage (``dist.batch_isend_irecv``,
where the reference uses ``ppermute``); the last stage banks the finished
micro-batches, and at the end its outputs reach every rank of the axis.

The schedule is differentiable, with the reference's semantics under
``jax.grad`` (its ``shard_map`` has ``in_specs=(P(axis), P())`` and
``out_specs=P()``).  One ``torch.autograd.Function`` holds the whole
schedule, so that every rank runs the backward's transfers in the same
order whatever its stage (autograd, left to order one node a transfer,
would skip the transfers of unused outputs on some ranks only):

* the output is replicated: the last stage takes the mean over the axis's
  ranks of their output cotangents (shard_map's transpose divides by S,
  ``psum``'s sums);
* the slots run in reverse, each stage taking the VJP of ``stage_fn`` at
  the input it saw, and each slot's input cotangent goes back to the
  previous stage (the ring shift's transpose); an idle slot passes its
  cotangent through, and stage 0 sends a zero one where it read the
  micro-batch and not its carry;
* ``x`` is replicated and only stage 0 reads it: every rank receives
  stage 0's gradient of ``x``;
* a leaf of ``stage_params`` that is a DTensor gets its local row's
  gradient; a plain ``(S, ...)`` stack, the same on every rank, gets the
  whole stack's gradient on every rank (each row from its stage).

With grad on, the forward keeps each active slot's graph (the stage's
activations of all its micro-batches, as the unpipelined stage keeps them
for the whole batch); with grad off it keeps nothing.  A transfer goes
through host memory when the group's backend is not NCCL (gloo ranks may
hold CUDA tensors) and adds its bytes and host seconds to
``sharded.BYTES``/``SECONDS``: ``ring`` (the bytes a rank sends),
``broadcast``, ``reduce`` and ``all_gather`` (the gathered bytes).  A
transfer that fails raises; nothing falls back.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from ..device import is_dtensor
from ..tree import tree_leaves, tree_unflatten


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def _wire(t: torch.Tensor, group, copy: bool = False) -> torch.Tensor:
    """``t`` as it goes on the wire: in host memory when the backend
    cannot take it from the card (a copy where ``copy``)."""
    dev = "cpu" if _host_staged(t, group) else t.device
    return t.detach().to(dev, copy=copy).contiguous()


def _count(kind: str, buf: torch.Tensor, t0: float, n: int = 1) -> None:
    from .sharded import BYTES, SECONDS
    BYTES[kind] += n * buf.numel() * buf.element_size()
    SECONDS[kind] += time.perf_counter() - t0


def _ring_shift(y: torch.Tensor, group, sid: int, S: int,
                step: int = 1) -> torch.Tensor:
    """``y`` of stage ``sid`` sent to stage ``sid + step`` (mod S); returns
    what stage ``sid - step`` sent here.  The forward shifts activations
    with ``step=1``, the backward cotangents with ``step=-1``."""
    t0 = time.perf_counter()
    send = _wire(y, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (sid + step) % S), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (sid - step) % S), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("ring", send, t0)
    return recv.to(y.device)


def _broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Stage ``src``'s ``t`` on every rank of the group."""
    t0 = time.perf_counter()
    buf = _wire(t, group)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", buf, t0)
    return buf.to(t.device)


def _output_cotangent(g: torch.Tensor, group, S: int, root: int):
    """The transpose of the closing broadcast: the mean over the group's
    ranks of their output cotangents, on stage ``root`` (None elsewhere)."""
    t0 = time.perf_counter()
    buf = _wire(g, group, copy=True)
    dist.reduce(buf, dst=dist.get_global_rank(group, root), group=group)
    _count("reduce", buf, t0)
    if dist.get_rank(group) != root:
        return None
    return buf.to(g.device) / S


def _leaf_grad(row: torch.Tensor, leaf: torch.Tensor, gather: bool,
               run) -> torch.Tensor:
    """A leaf's gradient from its stage row's: with ``gather`` (a plain
    ``(S, ...)`` stack, the same on every rank) every stage's row,
    gathered on every rank; else (a DTensor's local rows, a one-stage
    stack) this row in row 0."""
    if gather:
        t0 = time.perf_counter()
        buf = _wire(row, run.group)
        rows = [torch.empty_like(buf) for _ in range(run.S)]
        dist.all_gather(rows, buf, group=run.group)
        _count("all_gather", buf, t0, run.S)
        row = torch.stack(rows).to(leaf.device)
    else:
        row = row.unsqueeze(0)
    if leaf.shape[0] == row.shape[0]:
        return row
    out = leaf.new_zeros(leaf.shape)
    out[:row.shape[0]] = row
    return out


class _Run:
    """One call's schedule: the stage function, the params' structure,
    this rank's stage ``sid`` of ``S`` over ``group``."""

    def __init__(self, stage_fn, stage_params, dtensor, group, sid, S,
                 num_micro):
        self.stage_fn, self.tree, self.dtensor = stage_fn, stage_params, dtensor
        self.group, self.sid, self.S, self.num_micro = group, sid, S, num_micro
        self.slots = num_micro + S - 1
        # a stage past the first sends its input's cotangent back; stage 0
        # takes it only for x's gradient
        self.input_grad = sid > 0

    def rows(self, leaves):
        """This stage's slice of each leaf: the local row of a DTensor,
        else row ``sid`` of the stack."""
        return [l[0] if d else l[self.sid]
                for l, d in zip(leaves, self.dtensor)]

    def active(self, t: int) -> bool:
        return 0 <= t - self.sid < self.num_micro

    def forward(self, x, rows, kept=None):
        """The slots; with ``kept`` a list, each active slot's ``(input,
        output)`` is appended to it, the output with its graph."""
        S, sid, nm = self.S, self.sid, self.num_micro
        params = tree_unflatten(self.tree, rows)
        micro = x.reshape((nm, x.shape[0] // nm) + tuple(x.shape[1:]))
        out = torch.zeros_like(micro)
        carry = torch.zeros_like(micro[0])
        for t in range(self.slots):
            # stage 0 ingests micro-batch t; stage s works on t - s when
            # in range
            xin = micro[min(t, nm - 1)] if sid == 0 else carry
            if not self.active(t):
                y = carry
            elif kept is None:
                y = self.stage_fn(params, xin)
            else:
                with torch.enable_grad():
                    xg = xin.detach().requires_grad_(self.input_grad)
                    y = self.stage_fn(params, xg)
                kept.append((xg, y))
                y = y.detach()
            if sid == S - 1 and t >= S - 1:
                out[t - (S - 1)] = y
            carry = _ring_shift(y, self.group, sid, S) if S > 1 else y
        # only the last stage holds real outputs: broadcast them
        if S > 1:
            out = _broadcast(out, self.group, S - 1)
        return out.reshape(x.shape)

    def backward(self, g_out, kept, grads_of):
        """The slots in reverse: returns the cotangent of each micro-batch
        of ``x`` (stage 0's; a buffer to receive it elsewhere) and of each
        row in ``grads_of`` (None where a row's gradient is not asked for
        or is zero)."""
        S, sid, nm = self.S, self.sid, self.num_micro
        g_out = g_out.reshape((nm, -1) + tuple(g_out.shape[1:]))
        ct_out = (_output_cotangent(g_out, self.group, S, S - 1) if S > 1
                  else g_out)
        gx = torch.zeros_like(g_out) if sid == 0 else torch.empty_like(g_out)
        gp = [None] * len(grads_of)
        ct_carry = None
        for t in reversed(range(self.slots)):
            # this slot's output: what the next stage's carry took back,
            # (the transpose of slot t's shift; the last slot's carry is
            # dropped), plus the banked micro-batch's cotangent
            if t == self.slots - 1:
                gy = torch.zeros_like(g_out[0])
            elif S > 1:
                gy = _ring_shift(ct_carry, self.group, sid, S, step=-1)
            else:
                gy = ct_carry
            if sid == S - 1 and t >= S - 1:
                gy = gy + ct_out[t - (S - 1)]
            if not self.active(t):
                ct_carry = gy
                continue
            xg, y = kept.pop()
            want = ([xg] if xg.requires_grad else []) + [
                p for p in grads_of if p is not None]
            got = (torch.autograd.grad(y, want, gy, allow_unused=True)
                   if y.requires_grad else [None] * len(want))
            rest = iter(got)
            gin = next(rest) if xg.requires_grad else None
            for i, p in enumerate(grads_of):
                g = None if p is None else next(rest)
                if g is not None:
                    gp[i] = g if gp[i] is None else gp[i] + g
            if gin is None:
                gin = torch.zeros_like(gy)
            if sid == 0:
                gx[t] = gin
                ct_carry = torch.zeros_like(gy)
            else:
                ct_carry = gin
        return gx, gp


class _Pipeline(torch.autograd.Function):
    """The whole schedule as one node of the graph: inputs ``x`` and the
    leaves of ``stage_params`` (a DTensor's local tensor)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        rows = run.rows(leaves)
        wants = ctx.needs_input_grad[2:]
        grads_of = [r.detach().requires_grad_() if w else None
                    for r, w in zip(rows, wants)]
        run.input_grad = run.input_grad or ctx.needs_input_grad[1]
        kept = []
        out = run.forward(x, [g if g is not None else r
                              for g, r in zip(grads_of, rows)], kept)
        ctx.run, ctx.kept, ctx.grads_of = run, kept, grads_of
        ctx.leaves = leaves
        return out

    @staticmethod
    def backward(ctx, g_out):
        run, leaves = ctx.run, ctx.leaves
        gx, gp = run.backward(g_out, ctx.kept, ctx.grads_of)
        ctx.kept = ctx.grads_of = ctx.leaves = None
        dx = None
        if ctx.needs_input_grad[1]:
            if run.S > 1:
                gx = _broadcast(gx, run.group, 0)
            dx = gx.reshape(g_out.shape)
        return (None, dx, *(
            _leaf_grad(g if g is not None else torch.zeros_like(leaf[0]),
                       leaf, not d and run.S > 1, run) if w else None
            for leaf, d, g, w in zip(leaves, run.dtensor, gp,
                                     ctx.needs_input_grad[2:])))


def pipeline_apply(stage_fn: Callable, stage_params, x, mesh,
                   axis: str = "pod", num_micro: int = 4):
    """Run ``y = stage_{S-1}(...stage_0(x))`` pipelined over ``axis``.

    stage_fn(params_slice, xb) -> yb — one stage's computation on one
    micro-batch (all stages share this callable; per-stage behaviour comes
    from ``stage_params``, a tree of nested dicts whose leaves carry a
    leading stage dim: the whole (S, ...) stack, or a DTensor sharded over
    ``axis``).  ``yb`` has ``xb``'s shape and dtype.

    x: (B, ...) with B % num_micro == 0, the same on every rank of the
    axis; returns the same shape on every rank.  Differentiable in ``x``
    and the leaves of ``stage_params`` (see the module's docstring for the
    gradient each receives); every rank of the axis must call it, and run
    its backward, alike."""
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    B = x.shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} is not a multiple of "
                         f"num_micro={num_micro}")
    given = tree_leaves(stage_params)
    dtensor = [is_dtensor(l) for l in given]
    leaves = [l.to_local() if d else l for l, d in zip(given, dtensor)]
    run = _Run(stage_fn, stage_params, dtensor, mesh.get_group(axis),
               mesh.get_local_rank(axis), S, num_micro)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(l.requires_grad for l in leaves)):
        return _Pipeline.apply(run, x, *leaves)
    return run.forward(x, run.rows(leaves))
