"""Per-group core-set construction for matroid-constrained diversity (port
of ``repro.constrained.coreset``).

The matroid-coreset composition theorem (Ceccarello et al., arXiv:2002.03175)
says that the union, over the ``m`` groups, of an unconstrained core-set
built on each group alone is a core-set for the constrained problem, for
every label-count matroid (partition quotas exact or ranged, transversal,
laminar; see ``constrained.matroid``).  So GMM (or GMM-EXT for the
clique-type measures that need the injective proxy) runs once per group,
and the union is tagged with group labels.

The ``m`` per-group runs advance in lock-step on the single-sweep selection
engine (``core.gmm._schedule_select_impl`` with m > 1).  The running-min
field is shared and ``(n,)``: a point only needs its distance to its own
group's selected centers, so every sweep costs ``n·b·d`` distance work.  On
a CUDA device the sweep is the hand-written B4 kernel
(``kernels.ops.grouped_gmm_topb``), which computes only the own-group
distances; otherwise it is the plain torch version.

The delegates pass of the clique-type measures finds every row's nearest
own-group kernel center one group at a time, in bounded row chunks of a
``(rows, k')`` distance tile through the B3 kernel (``kernels.ops.pairwise``)
or its plain version, then an argmin: ``n·k'·d`` work, and no ``(n, m·k')``
matrix and no ``(chunk, k', d)`` gathered tile is ever held.

The reference's legacy vmapped oracles (``_grouped_gmm_impl``,
``_grouped_ext_impl``) are its test oracles and are not ported; the port's
tests run the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.gmm import (_adjust_chunk, _schedule_select_impl, _sweep_points,
                        delegates_from_assign, effective_block,
                        schedule_fold_sizes)
from ..core.measures import NEEDS_INJECTIVE
from ..core.metrics import get_metric
from ..device import (as_points, resolve_device, resolve_use_pallas,
                      to_numpy)
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs.trace import (count as _count, counting as _counting,
                         sweep_bytes as _sweep_bytes)


class GroupedCoreset(NamedTuple):
    """Union of per-group core-sets, kept in original-index space.

    ``idx[g, t]`` indexes the *original* point array, so callers return row
    indices without a nearest-row search.  ``s`` is ``kprime`` (plain) or
    ``kprime * k`` (ext delegates).  Tensors live on the run's device."""
    idx: torch.Tensor          # (m, s) int64 into the original points
    valid: torch.Tensor        # (m, s) bool
    radius: torch.Tensor       # (m,) per-group proxy-distance bound r_T
    group_count: torch.Tensor  # (m,) int32 — |group g| in the input
    cert: Optional[object] = None  # RadiusCertificate (adaptive/auto paths)

    def flatten(self):
        """Host-side (cand_idx, cand_labels) for the valid union rows."""
        idx = to_numpy(self.idx)
        valid = to_numpy(self.valid)
        m, s = idx.shape
        labels = np.repeat(np.arange(m, dtype=np.int32), s)
        keep = valid.reshape(-1)
        return idx.reshape(-1)[keep], labels[keep]

    @property
    def size(self) -> int:
        return int(to_numpy(self.valid).sum())


def _group_stats(labels, m: int):
    """(masks (m, n), counts (m,) int32, starts (m,) int64): each group's
    rows, its size and its first row (0 for an empty group)."""
    masks = labels[None, :] == torch.arange(m, dtype=labels.dtype,
                                            device=labels.device)[:, None]
    counts = masks.sum(dim=1).to(torch.int32)
    starts = torch.argmax(masks.to(torch.uint8), dim=1)
    return masks, counts, starts


# --------------------------------------------------------------------------
# the single-sweep selection engine, per group
# --------------------------------------------------------------------------

def _grouped_select_impl(points, labels, m: int, kprime: int, b: int,
                         chunk: int, metric_name: str, use_pallas: bool,
                         schedule=None, prep=None, grouped: bool = False):
    """All ``m`` per-group GMM runs in lock-step: one fused sweep per round.

    Returns (idx (m, k'), valid (m, k'), radius (m,), counts (m,),
    min_dist (n,)).  ``b=1`` is exact per-group GMM; ``b>1`` the lookahead-b
    approximation (kprime must be a multiple of b); ``schedule`` overrides
    ``b`` with an explicit (block, rounds) phase plan.  ``prep`` passes the
    sweep invariants in (computed here when None); ``grouped`` as in
    ``core.gmm._schedule_select_impl``."""
    _, counts, starts = _group_stats(labels, m)
    if schedule is None:
        schedule = ((b, kprime // b),)
    if prep is None:
        prep = _sweep_points(points, metric_name)
    idx, rad, min_dist, _, _ = _schedule_select_impl(
        prep, points, labels, starts, m, kprime, schedule, chunk,
        metric_name, use_pallas, grouped)
    radius = torch.where(counts > 0, torch.clamp(rad, min=0.0),
                         torch.zeros_like(rad))
    # a group with c < k' members yields duplicate selections at the tail;
    # slots >= c are marked invalid (greedy exhausts distinct points first)
    valid = (torch.arange(kprime, device=points.device)[None, :]
             < torch.clamp(counts, max=kprime)[:, None])
    return idx, valid, radius, counts, min_dist


def _grouped_delegates_impl(points, labels, idx, m: int, k: int, kprime: int,
                            chunk: int, metric_name: str, use_pallas: bool,
                            prep=None):
    """Delegate extraction for a grouped kernel ``idx`` (m, k'): every row's
    nearest OWN-group kernel center, one group at a time in row chunks of a
    ``(chunk, k')`` distance tile (the B3 kernel with ``use_pallas``, its
    plain version otherwise; the same chain of rounded products and adds,
    so both pick the same centers), then the shared delegate extraction per
    group.  Returns (didx (m, k'·k), dvalid (m, k'·k), mult (m, k')), where
    ``mult[g, j]`` = min(|cluster j of group g|, k) is GMM-GEN's
    multiplicity.  The group sizes are read to the host once.  ``prep``
    passes the run's sweep invariants (``core.gmm._sweep_points``) in."""
    n = points.shape[0]
    dev = points.device
    masks, counts, _ = _group_stats(labels, m)
    ch = _adjust_chunk(n, chunk or 4096)
    kernel_metric = metric_name in ("euclidean", "sqeuclidean", "cosine")
    if prep is None:
        prep = (kops.prepare(points, metric_name) if kernel_metric
                else kops.Prepared(points, None))
    order = torch.argsort(labels.to(torch.int64), stable=True)
    # one read: the group sizes and the rows labelled below 0, which sort
    # first (a label >= m sorts last and is never reached)
    stats = to_numpy(torch.cat([counts.to(torch.int64),
                                (labels < 0).sum().reshape(1)]))
    sizes, first = stats[:m], int(stats[m])
    assign = torch.zeros((n,), dtype=torch.int64, device=dev)
    for g in np.flatnonzero(sizes):
        rows = order[first:first + sizes[g]]
        first += int(sizes[g])
        cidx = idx[g]
        centers = prep.points.index_select(0, cidx)
        csq = None if prep.xsq is None else prep.xsq.index_select(0, cidx)
        for s in range(0, rows.shape[0], ch):
            r = rows[s:s + ch]
            x = prep.points.index_select(0, r)
            xsq = None if prep.xsq is None else prep.xsq.index_select(0, r)
            if not kernel_metric:
                dist = get_metric(metric_name).pairwise(x, centers)
            elif use_pallas:
                dist = kops.pairwise(x, centers, metric_name, xsq=xsq,
                                     ysq=csq, prepared=True)
            else:
                dist = kref.pairwise_ref(x, centers, metric_name, xsq=xsq,
                                         ysq=csq)
            assign.index_copy_(0, r, torch.argmin(dist, dim=1))
    didx, dvalid, mult = [], [], []
    for g in range(m):
        cand, valid, mg, _ = delegates_from_assign(idx[g], assign, masks[g],
                                                   k, kprime)
        didx.append(cand.reshape(-1))
        dvalid.append(valid.reshape(-1))
        mult.append(mg)
    # an empty group contributes nothing (the center-forcing step in the
    # delegate extraction would otherwise fabricate one spurious delegate)
    dvalid = torch.stack(dvalid) & (counts > 0)[:, None]
    return torch.stack(didx), dvalid, torch.stack(mult)


def _grouped_ext_blocked_impl(points, labels, m: int, k: int, kprime: int,
                              b: int, chunk: int, metric_name: str,
                              use_pallas: bool, schedule=None, prep=None,
                              grouped: bool = False):
    """Grouped GMM-EXT on the single-sweep engine: blocked (or scheduled)
    selection + the one-pass delegate extraction.  Returns (didx, dvalid,
    radius, counts)."""
    if prep is None:
        prep = _sweep_points(points, metric_name)
    idx, _, radius, counts, _ = _grouped_select_impl(
        points, labels, m, kprime, b, chunk, metric_name, use_pallas,
        schedule=schedule, prep=prep, grouped=grouped)
    didx, dvalid, _ = _grouped_delegates_impl(points, labels, idx, m, k,
                                              kprime, chunk, metric_name,
                                              use_pallas, prep=prep)
    return didx, dvalid, radius, counts


# --------------------------------------------------------------------------
# adaptive (auto-tuned) grouped builder
# --------------------------------------------------------------------------

def grouped_adaptive(points, labels, m: int, k: int, kprime, *,
                     measure: str = "remote-edge", metric="euclidean",
                     use_pallas="auto", b="auto", chunk: int = 0,
                     eps: Optional[float] = None,
                     kprime_max: Optional[int] = None,
                     tau: Optional[float] = None,
                     cliff: Optional[float] = None,
                     sprint="auto", device=None) -> GroupedCoreset:
    """Radius-certified grouped builder: all m per-group GMM runs advance in
    lock-step under the adaptive-b controller (``core.adaptive``), shrinking
    the lookahead block when ANY inhabited group's greedy-consistency margin
    falls below its fresh radius; ``kprime="auto"`` additionally grows k'
    until every inhabited group's measured certificate ratio meets ``eps``.
    Returns a ``GroupedCoreset`` whose ``cert`` carries the worst-group
    certificate plus per-group ratios."""
    from ..core.adaptive import (_ratio, adaptive_select, auto_milestones,
                                 certificate_from_trajectory)

    points = as_points(points, device)
    labels_np = np.asarray(to_numpy(labels)).astype(np.int64)
    n = points.shape[0]
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, points.device, metric_name)
    counts_np = np.bincount(labels_np[labels_np >= 0], minlength=m)[:m]
    starts = np.zeros((m,), np.int64)
    for g in range(m):
        hits = np.nonzero(labels_np == g)[0]
        starts[g] = hits[0] if hits.size else 0
    b0 = 8 if b == "auto" else max(1, int(b))
    eps_t = 0.1 if eps is None else eps
    labels_t = torch.as_tensor(labels_np, dtype=torch.int32,
                               device=points.device)
    if kprime == "auto":
        kmax, miles = auto_milestones(k, n, kprime_max)
        run = adaptive_select(points, labels_t, starts, m, kmax, b0=b0,
                              tau=tau, cliff=cliff, chunk=chunk,
                              metric=metric, use_pallas=use_pallas,
                              milestones=miles, eps=eps_t, scale_count=k,
                              group_counts=counts_np, sprint=sprint)
    else:
        run = adaptive_select(points, labels_t, starts, m, int(kprime),
                              b0=b0, tau=tau, cliff=cliff, chunk=chunk,
                              metric=metric, use_pallas=use_pallas,
                              scale_count=k, group_counts=counts_np,
                              sprint=sprint)
    kp = run.ksel
    dev = points.device
    counts = torch.as_tensor(counts_np.astype(np.int32), device=dev)
    radius = torch.as_tensor(
        np.where(counts_np > 0, np.maximum(run.radius, 0.0), 0.0)
        .astype(np.float32), device=dev)
    # per-group certificate ratios (scale sampled at the first >= k fold)
    si = next((i for i, c in enumerate(run.counts) if c >= k),
              len(run.counts) - 1)
    ratios = tuple(
        _ratio(max(float(run.radius[g]), 0.0), float(run.traj[si, g]))
        if counts_np[g] > 0 else 0.0 for g in range(m))
    cert = certificate_from_trajectory(
        run.counts, np.maximum(run.traj, 0.0).max(axis=1), k,
        eps=eps_t if kprime == "auto" else eps,
        b_schedule=run.schedule, group_ratios=ratios)
    idx = torch.as_tensor(run.idx, device=dev)
    if measure in NEEDS_INJECTIVE:
        didx, dvalid, _ = _grouped_delegates_impl(points, labels_t, idx, m,
                                                  k, kp, chunk, metric_name,
                                                  use_pallas)
        return GroupedCoreset(idx=didx, valid=dvalid, radius=radius,
                              group_count=counts, cert=cert)
    valid = (torch.arange(kp, device=dev)[None, :]
             < torch.clamp(counts, max=kp)[:, None])
    return GroupedCoreset(idx=idx, valid=valid, radius=radius,
                          group_count=counts, cert=cert)


# --------------------------------------------------------------------------
# public builder
# --------------------------------------------------------------------------

def grouped_coreset(points, labels, m: Optional[int] = None,
                    k: Optional[int] = None, kprime=None, *,
                    matroid=None, measure: str = "remote-edge",
                    metric="euclidean", use_pallas="auto", b=1,
                    chunk: int = 0, schedule=None,
                    eps: Optional[float] = None,
                    tau: Optional[float] = None,
                    cliff: Optional[float] = None,
                    sprint="auto", device=None) -> GroupedCoreset:
    """Build the union-of-per-group core-sets for a label-count matroid.

    ``labels`` is an ``(n,)`` int array in ``[0, m)``.  Each group
    contributes a core-set of size ``min(kprime, |group|)`` (plus delegates
    for the clique-type measures); empty groups contribute nothing.  Every
    per-group core-set is sized for the total ``k``: a feasible solution of
    any label-count matroid takes at most ``k`` points from one group.
    ``matroid=`` derives ``m``/``k`` from an oracle.

    ``b=1`` (default) is exact per-group GMM, ``b>1`` lookahead-b center
    blocking (snapped to a divisor of ``kprime``), ``b="auto"`` /
    ``kprime="auto"`` the radius-certified adaptive controller
    (``grouped_adaptive``), ``schedule`` an explicit (block, rounds) plan.
    ``use_pallas="auto"`` runs the B4 sweep kernel on a CUDA device;
    ``device`` defaults to the card (a missing one raises).
    """
    from .matroid import derive_mk

    m, k = derive_mk(matroid, m, k, "grouped_coreset")
    if kprime is None:
        raise ValueError("grouped_coreset needs kprime")
    points = as_points(points, device)
    labels = torch.as_tensor(np.asarray(to_numpy(labels)), dtype=torch.int32,
                             device=points.device)
    n = points.shape[0]
    if labels.shape != (n,):
        raise ValueError(f"labels shape {tuple(labels.shape)} != ({n},)")
    if b == "auto" or kprime == "auto":
        return grouped_adaptive(points, labels, m, k, kprime,
                                measure=measure, metric=metric,
                                use_pallas=use_pallas, b=b, chunk=chunk,
                                eps=eps, tau=tau, cliff=cliff, sprint=sprint)
    if not 1 <= kprime <= n:
        raise ValueError(f"kprime={kprime} out of range for n={n}")
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, points.device, metric_name)
    if schedule is None:
        b = effective_block(kprime, b)
    if _counting():
        folds = schedule_fold_sizes(schedule if schedule is not None
                                    else ((b, kprime // b),))
        _count("device_dispatches")
        _count("distance_evals", n * sum(folds))
        _count("bytes_swept", _sweep_bytes(n, int(points.shape[1]),
                                           sweeps=len(folds), m=m))
    if measure in NEEDS_INJECTIVE:
        idx, valid, radius, counts = _grouped_ext_blocked_impl(
            points, labels, m, k, kprime, b, chunk, metric_name, use_pallas,
            schedule=schedule)
    else:
        idx, valid, radius, counts, _ = _grouped_select_impl(
            points, labels, m, kprime, b, chunk, metric_name, use_pallas,
            schedule=schedule)
    return GroupedCoreset(idx=idx, valid=valid, radius=radius,
                          group_count=counts)


def fair_diversity_maximize(points, labels, quotas=None,
                            measure: str = "remote-edge", *, matroid=None,
                            kprime=None, metric="euclidean",
                            use_pallas="auto", swap_rounds: int = 10,
                            b=1, chunk: int = 0,
                            eps: Optional[float] = None,
                            tau: Optional[float] = None,
                            cliff: Optional[float] = None, device=None):
    """End-to-end single-machine constrained pipeline: per-group core-set →
    feasible-greedy + oracle-checked local-search solve on the union.

    Legacy spelling of ``repro_torch.diversify`` with a constrained
    ``ProblemSpec`` — prefer the facade for new code.  ``quotas=`` is sugar
    for an exact-quota ``PartitionMatroid``; pass ``matroid=`` for quota
    ranges, transversal or laminar constraints.  Returns (indices (k,) into
    ``points`` forming a feasible matroid basis, value, GroupedCoreset).
    ``use_pallas`` defaults to ``"auto"`` (the reference's ``False`` picks
    its XLA path); ``device``: the points' device when they are a tensor,
    else the card.
    """
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify
    from .matroid import as_matroid

    _warn_legacy("repro_torch.constrained.fair_diversity_maximize")
    mat = as_matroid(matroid, quotas)
    res = diversify(
        ProblemSpec(points=points, k=mat.k, measure=measure, metric=metric,
                    labels=labels, matroid=mat),
        ExecutionSpec(mode="batch", kprime=kprime, b=b, chunk=chunk,
                      eps=eps, use_pallas=use_pallas,
                      swap_rounds=swap_rounds, tau=tau, cliff=cliff,
                      device=str(resolve_device(device, like=points))))
    return res.indices, res.value, res.coreset
