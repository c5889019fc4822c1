"""MapReduce matroid-constrained diversity, simulated on one device or on a
mesh of ``torch.distributed`` ranks (port of
``repro.constrained.mapreduce``).

The MR rounds are matroid-agnostic — they only see group labels; the
matroid oracle (``quotas=`` sugar or ``matroid=``) enters at the final
solve.  Round 1: every reducer builds the per-group core-set of its shard
(m GMM / GMM-EXT runs); round 2: the feasible greedy + local-search solver
on the union.

The reference vmaps one grouped core-set per shard.  Here all ℓ reducers'
m groups are the ℓ·m groups of ONE grouped-engine run over the partitioned
array, with labels = reducer · m + group: every row folds only its own
(reducer, group) centers, so every fold of the whole round is one grouped
sweep (B4 on the card), and EXT's delegates one B3 pass per (reducer,
group).  Each (reducer, group) starts at its first row in the shard, as the
reference's per-shard engine does.  Round 1 is charged by the reference's
model counters (``core.distributed._count_round1``).  ``trace="reducers"``
and ``resilience=`` run it one reducer at a time, as
``core.distributed`` does, with the same result.

The mesh path (``mr_grouped_coreset``, ``mr_fair_diversity``) runs one
rank a reducer, as ``core.distributed``'s does: each rank builds the
per-group core-set of its rows (the grouped engine over its m groups, B4 a
fold on the card), round 2 gathers the per-rank blocks in the reference's
tiled order, and the solver runs on the union on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.distributed import (_count_round1, _gather_round1,
                                _mesh_unit_round, _reducer_units,
                                _resolve_reducer_plan, _round1_schedule,
                                _round1_span,
                                _sim_round1_detail, _sim_round1_resilient,
                                partition_shards)
from ..core.measures import NEEDS_INJECTIVE
from ..core.metrics import get_metric
from ..device import resolve_use_pallas, to_numpy
from ..obs.trace import (count as _count, counting as _counting,
                         reducer_detail as _reducer_detail)
from .coreset import _grouped_ext_blocked_impl, _grouped_select_impl
from .solver import solve_and_value


class FairCoreset(NamedTuple):
    """Union core-set tagged with group labels (points, not input indices —
    the reducers' rows are gathered into one union)."""
    points: torch.Tensor     # (cap, d)
    labels: torch.Tensor     # (cap,) int32 group ids
    valid: torch.Tensor      # (cap,) bool
    radius: torch.Tensor     # () max per-group, per-reducer proxy radius
    cert: Optional[object] = None  # probe RadiusCertificate (auto paths)

    def compact(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(valid points on the core-set's device, their host labels)."""
        v = to_numpy(self.valid)
        keep = torch.as_tensor(v, device=self.points.device)
        return self.points[keep], to_numpy(self.labels)[v]

    @property
    def size(self) -> int:
        return int(to_numpy(self.valid).sum())


def _sim_round1(pts, slabels, m: int, k: int, kprime: int, metric_name: str,
                mode: str, b: int = 1, chunk: int = 0, schedule=None,
                use_pallas="auto", prep=None):
    """Round 1 of all ℓ reducers as one grouped run over the ℓ·m groups
    ``reducer · m + label`` (a label outside [0, m) matches no group).
    Returns per reducer (pts (l, m·s, d), labels (l, m·s) int32, valid
    (l, m·s), radius (l,)), the reference's layout; ``s`` = k' (plain) or
    k'·k (ext delegates).  ``prep`` passes the sweep invariants of ``pts``
    in."""
    num_reducers, per = slabels.shape
    dev = pts.device
    use_pallas = resolve_use_pallas(use_pallas, dev, metric_name)
    lab = slabels.to(torch.int32)
    red = torch.arange(num_reducers, dtype=torch.int32, device=dev)[:, None]
    glab = torch.where((lab >= 0) & (lab < m), red * m + lab,
                       torch.full_like(lab, -1)).reshape(-1)
    groups = num_reducers * m
    schedule = _round1_schedule(kprime, b, schedule)
    if mode == "ext":
        idx, valid, radius, _ = _grouped_ext_blocked_impl(
            pts, glab, groups, k, kprime, b, chunk, metric_name, use_pallas,
            schedule=schedule, prep=prep, grouped=True)
    else:
        idx, valid, radius, _, _ = _grouped_select_impl(
            pts, glab, groups, kprime, b, chunk, metric_name, use_pallas,
            schedule=schedule, prep=prep, grouped=True)
    s = idx.shape[1]
    # an invalid slot holds zeros, not whatever row the engine left there,
    # so it does not depend on the other groups of the run
    g_pts = torch.where(valid.reshape(-1, 1), pts[idx.reshape(-1)],
                        0.0).view(num_reducers, m * s, -1)
    g_lab = torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(
        s).repeat(num_reducers, 1)
    return (g_pts, g_lab, valid.view(num_reducers, m * s),
            radius.view(num_reducers, m).max(dim=1).values)


def _simulate_fair_mr_impl(points, labels, quotas=None, *, matroid=None,
                           num_reducers: int,
                           measure: str = "remote-edge",
                           kprime=None, metric="euclidean",
                           partition: str = "contiguous", seed: int = 0,
                           swap_rounds: int = 10, b=1, chunk: int = 0,
                           eps: float = 0.1, tau=None, cliff=None,
                           use_pallas="auto", device=None, resilience=None):
    """Execution body of the simulated ℓ-reducer constrained MR run (the
    ``repro_torch.diversify`` facade routes here).  Returns (sol (k, d)
    tensor on the points' device, sol_labels, value, cert, report) —
    ``report`` is the ``ResilienceReport`` when a ``ResiliencePolicy``
    governed the run, else None."""
    from .matroid import as_matroid

    mat = as_matroid(matroid, quotas)
    m, k = mat.m, mat.k
    if kprime is None:
        kprime = max(2 * k, 32)
    pts, shards, slabels = partition_shards(
        points, num_reducers, partition=partition, seed=seed,
        labels=np.asarray(to_numpy(labels), np.int32), device=device)
    d = pts.shape[1]
    per_shard = int(shards.shape[1])
    if kprime != "auto":
        kprime = min(kprime, per_shard)
    kprime, schedule, b, cert = _resolve_reducer_plan(
        pts, k, kprime, b, eps=eps, metric=metric, chunk=chunk,
        per_shard=per_shard, labels=to_numpy(slabels).reshape(-1), m=m,
        tau=tau, cliff=cliff, use_pallas=use_pallas)
    mode = "ext" if measure in NEEDS_INJECTIVE else "plain"

    if _counting():
        _count_round1(num_reducers, per_shard, d, kprime, b, schedule, mode)
    metric_name = get_metric(metric).name
    report = None
    with _round1_span(num_reducers, kprime,
                     _round1_schedule(kprime, b, schedule), groups=m):
        if resilience is not None or _reducer_detail():
            unit = _reducer_units(
                pts, num_reducers, metric_name,
                lambda rows, prep, i: _sim_round1(
                    rows, slabels[i:i + 1], m, k, kprime, metric_name, mode,
                    b, chunk, schedule, use_pallas, prep=prep))
            if resilience is not None:
                g_pts, g_lab, g_valid, g_rad, report = _sim_round1_resilient(
                    num_reducers, unit, resilience)
            else:
                g_pts, g_lab, g_valid, g_rad = _sim_round1_detail(
                    num_reducers, unit)
        else:
            g_pts, g_lab, g_valid, g_rad = _sim_round1(
                pts, slabels, m, k, kprime, metric_name, mode, b, chunk,
                schedule, use_pallas)
            _count("device_dispatches")
    if report is not None and report.degraded:
        from ..distributed.fault_tolerance import degraded_certificate
        cert = degraded_certificate(cert, kprime=kprime,
                                    radius=float(torch.max(g_rad)),
                                    survivors=report.survivors,
                                    total=num_reducers, per_shard=per_shard)
    flat_valid = g_valid.reshape(-1)
    cand_pts = g_pts.reshape(-1, d)[flat_valid]
    cand_lab = to_numpy(g_lab.reshape(-1)[flat_valid])
    sel, value = solve_and_value(cand_pts, cand_lab, measure=measure,
                                 matroid=mat, metric=metric,
                                 swap_rounds=swap_rounds)
    sol = cand_pts[torch.as_tensor(sel, device=cand_pts.device)]
    return sol, cand_lab[sel], value, cert, report


def simulate_fair_mr(points, labels, quotas=None, *, matroid=None,
                     num_reducers: int,
                     measure: str = "remote-edge",
                     kprime=None, metric="euclidean",
                     partition: str = "contiguous", seed: int = 0,
                     swap_rounds: int = 10, b=1, chunk: int = 0,
                     eps: float = 0.1, tau=None, cliff=None,
                     device="cuda"):
    """Simulate the ℓ-reducer 2-round constrained MR run on one device.

    Legacy spelling of ``repro_torch.diversify`` with a constrained
    ``ProblemSpec`` and ``ExecutionSpec(mode="mapreduce",
    num_reducers=...)`` — prefer the facade for new code.  Returns
    (solution_points, solution_labels, value), as host arrays."""
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify
    from .matroid import as_matroid

    _warn_legacy("repro_torch.constrained.simulate_fair_mr")
    mat = as_matroid(matroid, quotas)
    res = diversify(
        ProblemSpec(points=points, k=mat.k, measure=measure, metric=metric,
                    labels=labels, matroid=mat),
        ExecutionSpec(mode="mapreduce", num_reducers=num_reducers,
                      kprime=kprime, b=b, chunk=chunk, eps=eps,
                      partition=partition, seed=seed,
                      swap_rounds=swap_rounds, tau=tau, cliff=cliff,
                      device=device))
    return res.solution, res.labels, res.value


# --------------------------------------------------------------------------
# mesh path (torch.distributed)
# --------------------------------------------------------------------------

def _mesh_grouped_round1(points, labels, m: int, k: int, kprime, measure,
                         mesh, *, axes, metric, use_pallas, b, chunk: int,
                         eps: float, tau, cliff, device, resilience):
    """Rounds 1 and 2 of the constrained scheme on this rank.  Returns
    (FairCoreset union, report, comm, rows, this rank's host labels)."""
    metric_name = get_metric(metric).name
    mode = "ext" if measure in NEEDS_INJECTIVE else "plain"
    r = _mesh_unit_round(
        points, mesh, axes,
        lambda rows, lab, kp, b_, sched: _sim_round1(
            rows, torch.as_tensor(lab, device=rows.device)[None], m, k, kp,
            metric_name, mode, b_, chunk, sched, use_pallas),
        k=k, kprime=kprime, b=b, eps=eps, metric=metric, chunk=chunk,
        tau=tau, cliff=cliff, use_pallas=use_pallas, device=device,
        resilience=resilience, point="round:mr.round1", labels=labels, m=m,
        groups=m)
    _count("device_dispatches")
    if _counting():
        _count_round1(r.comm.size, r.per, r.d, r.kprime, r.b, r.schedule,
                      mode)
    (g_pts, g_lab, g_valid), radius = _gather_round1(r.comm, r.out[:3],
                                                     r.out[3], groups=m)
    cs = FairCoreset(points=g_pts, labels=g_lab, valid=g_valid,
                     radius=radius, cert=r.cert)
    return cs, r.report, r.comm, r.rows, r.labels


def mr_grouped_coreset(points, labels, m: Optional[int] = None,
                       k: Optional[int] = None, kprime=32,
                       measure: str = "remote-edge", mesh=None, *,
                       matroid=None, data_axes=("data",),
                       metric="euclidean", use_pallas="auto", b=1,
                       chunk: int = 0, eps: float = 0.1, tau=None,
                       cliff=None, device=None) -> FairCoreset:
    """2-round MR fair core-set on a mesh, called by every rank: ``points
    (n, d)`` and ``labels (n,)`` are DTensors placed ``Shard(0)`` over
    ``data_axes`` or the same full arrays on every rank; returns the union,
    the same on every rank.  ``matroid=`` derives ``m``/``k`` from an
    oracle (the construction itself only sees group labels).
    ``b="auto"``/``kprime="auto"`` probe the labelled input once and freeze
    every reducer's schedule."""
    from .matroid import derive_mk

    m, k = derive_mk(matroid, m, k, "mr_grouped_coreset")
    if mesh is None:
        raise ValueError("mr_grouped_coreset requires a mesh")
    return _mesh_grouped_round1(
        points, labels, m, k, kprime, measure, mesh, axes=tuple(data_axes),
        metric=metric, use_pallas=use_pallas, b=b, chunk=chunk, eps=eps,
        tau=tau, cliff=cliff, device=device, resilience=None)[0]


def _mr_fair_diversity_impl(points, labels, quotas=None,
                            measure: str = "remote-edge", mesh=None, *,
                            matroid=None, kprime=None, data_axes=("data",),
                            metric="euclidean", use_pallas="auto",
                            swap_rounds: int = 10, b=1, chunk: int = 0,
                            eps: float = 0.1, tau=None, cliff=None,
                            resilience=None, device=None):
    """Execution body of the constrained mesh MR pipeline, run by every
    rank (the ``repro_torch.diversify`` facade routes here).  Returns
    (sol (k, d) tensor, sol_labels, value, cert, report).  A
    ``ResiliencePolicy`` retries round 1 on all ranks together."""
    from .matroid import as_matroid

    if mesh is None:
        raise ValueError("mr_fair_diversity requires a mesh")
    mat = as_matroid(matroid, quotas)
    m, k = mat.m, mat.k
    if kprime is None:
        kprime = max(2 * k, 32)
    cs, report, *_ = _mesh_grouped_round1(
        points, labels, m, k, kprime, measure, mesh, axes=tuple(data_axes),
        metric=metric, use_pallas=use_pallas, b=b, chunk=chunk, eps=eps,
        tau=tau, cliff=cliff, device=device, resilience=resilience)
    cand_pts, cand_lab = cs.compact()
    sel, value = solve_and_value(cand_pts, cand_lab, measure=measure,
                                 matroid=mat, metric=metric,
                                 swap_rounds=swap_rounds)
    sol = cand_pts[torch.as_tensor(sel, device=cand_pts.device)]
    return sol, cand_lab[sel], value, cs.cert, report


def mr_fair_diversity(points, labels, quotas=None,
                      measure: str = "remote-edge", mesh=None, *,
                      matroid=None, kprime=None, data_axes=("data",),
                      metric="euclidean", use_pallas="auto",
                      swap_rounds: int = 10, b=1, chunk: int = 0,
                      eps: float = 0.1, tau=None, cliff=None,
                      device="cuda"):
    """Full constrained pipeline on a mesh, called by every rank
    (``quotas=`` is sugar for an exact-quota ``PartitionMatroid``; any
    label-count matroid works).

    Legacy spelling of ``repro_torch.diversify`` with a constrained
    ``ProblemSpec`` and ``ExecutionSpec(mode="mapreduce", mesh=...)`` —
    prefer the facade for new code.  Returns (solution_points (k, d),
    solution_labels (k,), value), as host arrays."""
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify
    from .matroid import as_matroid

    _warn_legacy("repro_torch.constrained.mr_fair_diversity")
    if mesh is None:
        raise ValueError("mr_fair_diversity requires a mesh")
    mat = as_matroid(matroid, quotas)
    res = diversify(
        ProblemSpec(points=points, k=mat.k, measure=measure, metric=metric,
                    labels=labels, matroid=mat),
        ExecutionSpec(mode="mapreduce", mesh=mesh,
                      data_axes=tuple(data_axes), kprime=kprime, b=b,
                      chunk=chunk, eps=eps, use_pallas=use_pallas,
                      swap_rounds=swap_rounds, tau=tau, cliff=cliff,
                      device=device))
    return res.solution, res.labels, res.value
