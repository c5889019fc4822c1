"""Collectives of the sharded train and serve steps (the counterpart of
what GSPMD inserts into the reference's sharded steps).

A leaf of the parameter tree is a ``DTensor`` placed by
``launch.sharding.named``: along each mesh dimension ``Shard(d)`` or
``Replicate()``, several mesh dimensions splitting one tensor dim in mesh
order (major to minor, as JAX splits a dim over a tuple of axes).  The
step computes on plain local tensors:

* ``gather`` — a leaf's sharded dims all-gathered before use, except the
  dims held over the mesh dims ``keep`` (the MoE experts over ``model``,
  and the tensor-parallel leaves' ``d_ff``, vocab and heads dims);
* ``reduce_grad`` — the gradient of that gathered tensor summed over the
  batch axes (the data ranks hold different rows) into this rank's
  shard: a reduce-scatter along a dim split over batch axes only, an
  all-reduce over the batch axes that split no dim of the leaf, and a
  slice (no sum) along a dim split over other axes, whose ranks computed
  the same gradient (a kept dim is this rank's own: its gradient is
  summed over the batch axes alone);
* ``CopyToGroup`` / ``ReduceFromGroup`` — Megatron's conjugate pair over
  a mesh axis: identity forward and all-reduce backward, all-reduce
  forward and identity backward (the MoE layer's replicated inputs and
  its combine over ``model``; the tensor-parallel products of
  ``models.common``), each sum taken in fp32 (float64 kept) and rounded
  once to the operand's dtype, as the reference's compiled all-reduces
  are promoted;
* ``SplitToGroup`` — Megatron's scatter-to-group: this rank's block of an
  input every rank holds whole, the blocks' cotangents all-gathered
  backward, so the gradient of a replicated leaf is whole and the same
  on every rank (the padded query heads and ``wo``'s rows under
  ``pad_heads``);
* ``Reshard`` — a tensor split along a dim re-split into other blocks,
  each piece sent point to point by the rank that holds it (the
  reference's collective-permutes: the context heads under
  ``pad_heads``, RoPE's partner columns under ``head_dim``); backward the
  cotangent's pieces sent back;
* ``LeafMeans`` — Adafactor's row and column means and its RMS over a
  whole leaf, summed over the ranks that split the dims they reduce;
* ``softmax_combine`` — the sharded serve steps' attention over a cache
  whose slots are split over a mesh axis: each rank's partial softmax
  sums, their max and their rescaled sums all-reduced.

Every collective runs over the process group of its mesh axes (the mesh's
own for one axis), through pinned host memory when the group's backend is
not NCCL (gloo ranks may hold CUDA tensors), and adds the bytes of its
buffer to ``BYTES`` (all-gather: its output; reduce-scatter: its input;
all-reduce: its buffer; collective-permute: what this rank sends) and its
host seconds, staging included, to
``SECONDS``.  A collective that fails raises; nothing falls back.
"""
from __future__ import annotations

import collections
import time
from typing import Sequence, Tuple

import torch

from ..core.distributed import _Comm, _pinned

# bytes a rank put through each kind of collective since the last reset,
# and the host seconds they took
BYTES = collections.Counter()
SECONDS = collections.Counter()


def reset() -> None:
    BYTES.clear()
    SECONDS.clear()


def _count(kind: str, buf, t0: float) -> None:
    BYTES[kind] += buf.numel() * buf.element_size()
    SECONDS[kind] += time.perf_counter() - t0


class AxisComm(_Comm):
    """The ranks of this rank's group over the mesh axes ``axes``, in
    row-major order of their coordinates (the reference's order of a dim
    split over those axes)."""

    def _wire(self, t):
        """A copy of ``t`` to reduce, in pinned host memory when the
        backend cannot take it from the card."""
        if self._host(t):
            return _pinned(t.contiguous())
        return t.contiguous().clone()

    def gather(self, t):
        t0 = time.perf_counter()
        out = super().gather(t)
        _count("all_gather", out, t0)
        return out

    def sum(self, t):
        """The sum of every rank's ``t`` (one shape on all ranks)."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        t0 = time.perf_counter()
        buf = self._wire(t)
        dist.all_reduce(buf, group=self.group)
        out = buf.to(t.device)
        _count("all_reduce", buf, t0)
        return out

    def max(self, t):
        """The elementwise MAX of every rank's ``t`` (one shape on all
        ranks; counted as an all-reduce)."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        t0 = time.perf_counter()
        buf = self._wire(t.reshape(-1))
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        out = buf.to(t.device).reshape(t.shape)
        _count("all_reduce", buf, t0)
        return out

    def reduce_scatter(self, t):
        """Rank ``i``'s block ``i`` along dim 0 of the sum of every rank's
        ``t`` (dim 0 a multiple of the group's size)."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of size {t.shape[0]} does not split "
                             f"over {self.size} ranks")
        t0 = time.perf_counter()
        buf = self._wire(t)
        blocks = list(buf.chunk(self.size))
        members = dist.get_process_group_ranks(self.group)
        ins = [blocks[self.order.index(r)].contiguous() for r in members]
        out = torch.empty_like(blocks[0])
        dist.reduce_scatter(out, ins, group=self.group)
        out = out.to(t.device)
        _count("reduce_scatter", buf, t0)
        return out

    def exchange(self, sends: dict, recvs: dict, like):
        """Point to point: each ``sends[j]`` to the group's rank ``j`` and
        from each rank ``j`` of ``recvs`` a tensor of shape ``recvs[j]`` and
        ``like``'s dtype; returns {j: tensor} on ``like``'s device.  Counted
        as ``collective_permute``, the bytes this rank sends.  On ``meta``
        tensors (the dry run) nothing moves."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        dev = "cpu" if self._host(like) else like.device
        ops, out, nbytes = [], {}, 0
        for j, t in sends.items():
            buf = t.contiguous().to(dev)
            nbytes += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.isend, buf, self.order[j], self.group))
        for j, shape in recvs.items():
            out[j] = torch.empty(shape, dtype=like.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, out[j], self.order[j],
                                  self.group))
        if ops and not like.is_meta:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if nbytes:
            BYTES["collective_permute"] += nbytes
        if ops:
            SECONDS["collective_permute"] += time.perf_counter() - t0
        return {j: t.to(like.device) for j, t in out.items()}


def softmax_combine(m, l, o, comm):
    """Attention over slots split over ``comm``'s ranks (flash-decoding's
    combine, forward only): from this rank's row max ``m`` (...), ``l =
    Σ exp(s − m)`` (...) and ``o = Σ exp(s − m)·v`` (..., hd) over its
    own slots, the max of ``m`` over the ranks (an all-reduce), each
    rank's partials rescaled by ``exp(m − M)``, ``l`` and ``o`` summed
    (one all-reduce of both), and ``o / l``.  A rank with no live slot
    passes ``l = 0`` and ``o = 0`` (its ``m`` the mask's fill), which the
    rescale keeps at 0; a row with no live slot on any rank gives a zero
    context, not a NaN."""
    big = comm.max(m)
    scale = torch.exp(m - big)
    lo = comm.sum(torch.cat([(l * scale)[..., None],
                             o * scale[..., None]], dim=-1))
    l, o = lo[..., 0], lo[..., 1:]
    return o / torch.where(l > 0, l, torch.ones_like(l))[..., None]


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def split_dims(placements) -> dict:
    """tensor dim -> the mesh dims that split it, in mesh order."""
    out = {}
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out.setdefault(pl.dim, []).append(i)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} is neither Shard nor "
                             f"Replicate")
    return out


def _chunk(t, dim: int, mesh, mesh_dims: Sequence[int]):
    """This rank's block of ``t`` along ``dim`` split over ``mesh_dims``
    (row-major over their coordinates, in mesh order)."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i in mesh_dims:
        size = int(mesh.size(i))
        idx, n = idx * size + coord[i], n * size
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"over {n} ranks")
    per = t.shape[dim] // n
    return t.narrow(dim, idx * per, per)


def gather(leaf, keep: Sequence[int] = ()):
    """The plain tensor of the DTensor ``leaf`` with every sharded dim
    gathered, except those split over the mesh dims ``keep`` (a dim split
    over kept and other mesh dims raises)."""
    mesh, names = leaf.device_mesh, _names(leaf.device_mesh)
    t = leaf.to_local()
    for dim, mdims in split_dims(leaf.placements).items():
        kept = [i for i in mdims if i in keep]
        if kept:
            if len(kept) != len(mdims):
                raise ValueError(f"dim {dim} is split over kept and gathered "
                                 f"mesh dims {mdims}")
            continue
        comm = AxisComm(mesh, [names[i] for i in mdims])
        t = comm.gather(t.movedim(dim, 0)).movedim(0, dim)
    return t


def reduce_grad(g, leaf, batch_axes: Sequence[str], keep: Sequence[int] = ()):
    """This rank's shard of the sum over the ``batch_axes`` ranks of ``g``,
    the gradient of ``gather(leaf, keep)``."""
    mesh, names = leaf.device_mesh, _names(leaf.device_mesh)
    batch = {names.index(a) for a in batch_axes}
    splits = {d: [i for i in m if i not in keep]
              for d, m in split_dims(leaf.placements).items()}
    splits = {d: m for d, m in splits.items() if m}
    # a dim split over non-batch axes only: every rank along them computed
    # the same gradient, so each takes its block
    for d, m in splits.items():
        if not batch.intersection(m):
            g = _chunk(g, d, mesh, m)
    used = set()
    for d, m in splits.items():
        if batch.issuperset(m):
            comm = AxisComm(mesh, [names[i] for i in m])
            g = comm.reduce_scatter(g.movedim(d, 0)).movedim(0, d)
            used.update(m)
    rest = sorted(batch - used)
    if rest:
        g = AxisComm(mesh, [names[i] for i in rest]).sum(g)
    # a dim split over batch and other axes: summed above, then its block
    for d, m in splits.items():
        if batch.intersection(m) and not batch.issuperset(m):
            g = _chunk(g, d, mesh, m)
    return g


def replicas(leaf) -> int:
    """Ranks holding each entry of the DTensor ``leaf`` (the product of the
    mesh dims that split none of its dims)."""
    n = 1
    for i, pl in enumerate(leaf.placements):
        if pl.is_replicate():
            n *= int(leaf.device_mesh.size(i))
    return n


def mesh_sum(t, mesh):
    """The sum of ``t`` over every rank of ``mesh``."""
    return AxisComm(mesh, _names(mesh)).sum(t)


def _promoted_sum(t, comm):
    """The sum of every rank's ``t`` over ``comm``, taken in fp32 (float64
    kept) and rounded once to ``t``'s dtype."""
    if comm.size == 1:
        return t
    wide = t if t.dtype == torch.float64 else t.float()
    return comm.sum(wide).to(t.dtype)


class CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over ``comm``'s ranks
    backward (an input every rank of the group uses for its own part)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _promoted_sum(g, ctx.comm), None


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce over ``comm``'s ranks forward (the parts summed); identity
    backward (every rank's part has the sum's gradient)."""

    @staticmethod
    def forward(ctx, x, comm):
        out = _promoted_sum(x, comm)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return g, None


class SplitToGroup(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``, ``x`` zero-padded there to
    ``total`` (a multiple of the group's size) and held whole by every
    rank of ``comm``; backward the blocks' cotangents all-gathered, so each
    rank's gradient of ``x`` is whole (scatter-to-group)."""

    @staticmethod
    def forward(ctx, x, comm, dim, total):
        dim %= x.ndim
        n = x.shape[dim]
        ctx.args = (comm, dim, n)
        per = total // comm.size
        lo = min(comm.rank * per, n)
        part = x.narrow(dim, lo, min(lo + per, n) - lo)
        if part.shape[dim] == per:
            return part.clone()
        shape = list(x.shape)
        shape[dim] = per - part.shape[dim]
        return torch.cat([part, x.new_zeros(shape)], dim)

    @staticmethod
    def backward(ctx, g):
        comm, dim, n = ctx.args
        whole = comm.gather(g.movedim(dim, 0)).movedim(0, dim)
        return whole.narrow(dim, 0, n), None, None, None


def _overlap(a, b):
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _move(x, comm, dim: int, src, dst):
    """``x``, rows ``src[comm.rank]`` along ``dim`` of a tensor whose rows
    ``src[j]`` rank ``j`` holds, as the rows ``dst[comm.rank]``: each piece
    sent by the rank that holds it (``src``'s blocks are disjoint, as are
    ``dst``'s)."""
    me, dim = comm.rank, dim % x.ndim
    sends, recvs, where = {}, {}, {}
    for j in range(comm.size):
        if j == me:
            continue
        o = _overlap(src[me], dst[j])
        if o:
            sends[j] = x.narrow(dim, o[0] - src[me][0], o[1] - o[0])
        o = _overlap(src[j], dst[me])
        if o:
            shape = list(x.shape)
            shape[dim] = o[1] - o[0]
            recvs[j], where[j] = shape, o
    got = comm.exchange(sends, recvs, x)
    shape = list(x.shape)
    shape[dim] = dst[me][1] - dst[me][0]
    out = x.new_zeros(shape)
    o = _overlap(src[me], dst[me])
    if o:
        out.narrow(dim, o[0] - dst[me][0], o[1] - o[0]).copy_(
            x.narrow(dim, o[0] - src[me][0], o[1] - o[0]))
    for j, o in where.items():
        out.narrow(dim, o[0] - dst[me][0], o[1] - o[0]).copy_(got[j])
    return out


class Reshard(torch.autograd.Function):
    """``x``, this rank's rows ``src[rank]`` (a ``(start, stop)`` of global
    indices) along ``dim`` of a tensor split over ``comm``'s ranks, as the
    rows ``dst[rank]``, each piece sent point to point by the rank that
    holds it; backward the cotangent's pieces sent back (rows no rank
    asks for get a zero gradient)."""

    @staticmethod
    def forward(ctx, x, comm, dim, src, dst):
        ctx.args = (comm, dim, src, dst)
        return _move(x, comm, dim, src, dst)

    @staticmethod
    def backward(ctx, g):
        comm, dim, src, dst = ctx.args
        return _move(g, comm, dim, dst, src), None, None, None, None


class LeafMeans:
    """Means over dims of a leaf placed as ``leaf`` (a DTensor), computed
    on its local shard and summed over the ranks that split the reduced
    dims (Adafactor's factored moments and its RMS clip)."""

    def __init__(self, leaf):
        self._mesh = leaf.device_mesh
        self._shape = tuple(leaf.shape)
        self._splits = split_dims(leaf.placements)

    def _sum_over(self, x, pdims):
        mdims = sorted({i for d in pdims for i in self._splits.get(d, ())})
        if not mdims:
            return x
        names = _names(self._mesh)
        return AxisComm(self._mesh, [names[i] for i in mdims]).sum(x)

    def mean(self, x, dim: int, pdim: int, keepdim: bool = False):
        """The mean of ``x`` over its dim ``dim``, which is the param's dim
        ``pdim``."""
        pdim %= len(self._shape)
        s = self._sum_over(x.sum(dim=dim, keepdim=keepdim), [pdim])
        return s / self._shape[pdim]

    def mean_all(self, x):
        """The mean of ``x``, shaped as the param's shard, over the whole
        param."""
        s = self._sum_over(x.sum(), range(len(self._shape)))
        n = 1
        for size in self._shape:
            n *= size
        return s / n
