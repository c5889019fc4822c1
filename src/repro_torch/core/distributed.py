"""MapReduce diversity maximization, simulated on one device (paper §5, §6.2;
port of the simulated half of ``repro.core.distributed``).

Round structure (Thm 6):
  round 1  — every reducer runs GMM / GMM-EXT / GMM-GEN on its shard;
  round 2  — the union of the per-reducer core-sets is solved by the
             sequential α-approx solver;
  round 3  — (generalized scheme, Thm 10) the chosen multiset is
             instantiated against the input (δ-instantiation, Lemma 7).

The reference vmaps one independent GMM per shard.  Here the ℓ reducers
are the groups of the grouped selection engine (``core.gmm.
_schedule_select_impl`` with labels = reducer id): each row folds only its
own reducer's centers and each reducer keeps its own top-p, so every fold
of all ℓ reducers is ONE grouped sweep, the B4 kernel on the card.  Each
reducer starts at its shard's first row, as the reference's per-shard GMM
does; EXT's delegates come from one B3 assignment pass per reducer, and
GEN's multiplicities from the same pass.

Round 1 is charged by the reference's model (``_count_round1``, one
``device_dispatches`` per round-1 dispatch of the reference, the
generalized scheme's multiplicity re-dispatch included), so the counters
compare; the engines' own counting does not run here, and
``kernels.ops.LAUNCHES`` counts the real launches.

``trace="reducers"`` and ``resilience=`` run round 1 one reducer at a
time instead (``_sim_round1_detail``, ``_sim_round1_resilient``): each
reducer is the same grouped run over its own rows alone, so it costs ℓ
launches a fold, gets its own ``mr.reducer[i]`` span (fenced on the
device, so ``StragglerPolicy`` sees device time) and is a unit that can be
retried or dropped.  A reducer's picks depend only on its own rows, and
the grouped sweep and in-block distances of a row depend only on its own
group, so these paths return the same tensors as the one-run path.

The mesh path (``mr_coreset``, ``mr_diversity``, the three-round and
recursive schemes over ``torch.distributed``) is ROADMAP slice 10b; its
functions raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import (NOT_PORTED, as_points, not_ported,
                      resolve_use_pallas, to_numpy)
from ..kernels.build import LAUNCHES
from ..kernels.ops import Prepared
from ..obs.trace import (_block, active as _obs_active, count as _count,
                         counting as _counting, launch_span as _launch_span,
                         reducer_detail as _reducer_detail, span as _span,
                         sweep_bytes as _sweep_bytes)
from .coreset import Coreset, GeneralizedCoreset
from .gmm import (_schedule_select_impl, _sweep_points, effective_block,
                  schedule_fold_sizes)
from .measures import NEEDS_INJECTIVE, solution_value
from .metrics import get_metric
from .sequential import instantiate, solve, solve_on_coreset

def _mesh_path(name: str):
    def fn(*args, **kwargs):
        raise not_ported("mesh", name)
    fn.__name__ = name
    fn.__doc__ = f"Not ported: {NOT_PORTED['mesh']}."
    return fn


mr_coreset = _mesh_path("mr_coreset")
mr_diversity = _mesh_path("mr_diversity")
mr_coreset_recursive = _mesh_path("mr_coreset_recursive")
_mr_diversity_impl = _mesh_path("_mr_diversity_impl")


# --------------------------------------------------------------------------
# reducer plan + model counters
# --------------------------------------------------------------------------

def _resolve_reducer_plan(points, k: int, kprime, b, *, eps: float,
                          metric, chunk: int, per_shard: int,
                          labels=None, m: int = 1, tau=None, cliff=None,
                          use_pallas="auto"):
    """Freeze ``b="auto"``/``kprime="auto"`` into static reducer inputs.

    All reducers share one schedule, so a cheap probe
    (``core.adaptive.resolve_engine_plan``) runs once on a subsample of the
    global input (on the card, through the sweep kernels) and its decisions
    become every reducer's static (block, rounds) schedule.  k' is clamped
    to the shard size.  Returns (kprime:int, schedule|None, b:int, probe
    RadiusCertificate|None)."""
    if b != "auto" and kprime != "auto":
        return kprime, None, b, None
    from .adaptive import plan_from_schedule, resolve_engine_plan

    with _span("mr.probe", k=k, kprime=kprime, b=b):
        kp, schedule, cert = resolve_engine_plan(
            points, k, kprime, b, eps=eps, metric=metric, labels=labels,
            m=m, chunk=chunk, use_pallas=use_pallas, tau=tau, cliff=cliff)
    kp = min(int(kp), per_shard)
    if schedule is not None:
        planned = sum(b_ * r for b_, r in schedule)
        if planned != kp:        # k' was clamped: re-fit the plan's fraction
            schedule = plan_from_schedule(schedule, kp, planned)
    # kprime="auto" with an explicit numeric b keeps that b (no schedule);
    # only b="auto" replaces the knob with the frozen plan
    return kp, schedule, (1 if b == "auto" else b), cert


def _count_round1(num_reducers: int, per_shard: int, d: int, kprime: int,
                  b, schedule, mode: str) -> None:
    """Model-based round-1 counters, the reference's: the schedule's exact
    fold count per reducer (the same accounting ``core.gmm`` uses on the
    host path), plus the EXT/GEN assignment pass."""
    if schedule is not None:
        folds = schedule_fold_sizes(schedule)
        sweeps, folded = len(folds), sum(folds)
    elif b not in (None, "auto") and b > 1:
        beff = effective_block(kprime, b)
        folds = schedule_fold_sizes(((beff, kprime // beff),))
        sweeps, folded = len(folds), sum(folds)
    else:
        sweeps, folded = kprime, kprime
    if mode in ("ext", "gen") and (schedule is not None
                                   or (b not in (None, "auto") and b > 1)):
        sweeps, folded = sweeps + 1, folded + kprime     # assignment pass
    _count("distance_evals", num_reducers * per_shard * folded)
    _count("bytes_swept",
           num_reducers * _sweep_bytes(per_shard, d, sweeps=sweeps))


def _round1_schedule(kprime: int, b, schedule):
    """The (block, rounds) schedule round 1 runs: the frozen probe plan,
    else k'/b blocks of ``b`` (snapped to a divisor of k'; b = 1 is exact
    GMM)."""
    if schedule is not None:
        return schedule
    b = effective_block(kprime, b)
    return ((b, kprime // b),)


def _round1_span(num_reducers: int, kprime: int, schedule, **attrs):
    """The ``mr.round1`` span of a simulated run.  Besides ``attrs`` it
    records the schedule round 1 runs, its fold count (one grouped sweep of
    all reducers each, or one per reducer on the per-reducer paths) and, on
    exit, the kernel launches made inside it, per kernel
    (``obs.trace.launch_span``).  A no-op unless a trace is enabled."""
    return _launch_span("mr.round1", LAUNCHES, reducers=num_reducers,
                        kprime=kprime, schedule=[list(s) for s in schedule],
                        folds=len(schedule_fold_sizes(schedule)), **attrs)


# --------------------------------------------------------------------------
# simulated reducers
# --------------------------------------------------------------------------

def partition_shards(points, num_reducers: int, *,
                     partition: str = "contiguous", seed: int = 0,
                     labels=None, device=None):
    """Reducer-partition prep shared by the simulated MR paths.

    Pads the input to a multiple of ``num_reducers`` by repeating leading
    rows (duplicates only add candidates — they never win a greedy pick
    while a distinct point remains, and no point is DROPPED: truncation
    would break quota feasibility for tiny groups in the constrained path).

    ``partition``: 'contiguous' | 'random' | 'adversarial' (paper §7.2 —
    adversarial = sort by first coordinate so each reducer sees a
    small-volume region).  The random permutation is numpy's
    ``default_rng(seed).permutation`` on the host, the reference's; the
    gathers run where the points live.  Returns (pts (l·per, d), shards
    (l, per, d) view of pts, slabels (l, per) int32 or None), on the
    points' device."""
    pts = as_points(points, device)
    n, d = pts.shape
    lab = (None if labels is None else torch.as_tensor(
        np.asarray(to_numpy(labels)), dtype=torch.int32, device=pts.device))
    per = -(-n // num_reducers)                      # ceil
    pad = per * num_reducers - n
    if pad:
        pts = torch.cat([pts, pts[:pad]])
        lab = None if lab is None else torch.cat([lab, lab[:pad]])
    order = None
    if partition == "random":
        order = torch.as_tensor(
            np.random.default_rng(seed).permutation(per * num_reducers),
            device=pts.device)
    elif partition == "adversarial":
        order = torch.argsort(pts[:, 0], stable=True)
    if order is not None:
        pts = pts.index_select(0, order)
        lab = None if lab is None else lab.index_select(0, order)
    slabels = None if lab is None else lab.view(num_reducers, per)
    return pts, pts.view(num_reducers, per, d), slabels


def _reducer_labels(num_reducers: int, per: int, device):
    """Engine labels and seeds of the simulated reducers: row i of the
    partitioned array belongs to reducer i // per, which starts at its
    shard's first row."""
    lab = torch.arange(num_reducers, dtype=torch.int32,
                       device=device).repeat_interleave(per)
    return lab, torch.arange(num_reducers, device=device) * per


def _sim_round1(pts, num_reducers: int, k: int, kprime: int, metric: str,
                mode: str, b: int = 1, chunk: int = 0, schedule=None,
                use_pallas="auto", prep=None):
    """Round 1 of all ℓ reducers as ONE grouped-engine run over the
    partitioned array ``pts`` (l·per, d), labels = reducer id: every fold of
    every reducer is one grouped sweep (B4 on the card).  ``schedule`` is the
    frozen probe plan, else ``b`` lookahead blocks (snapped to a divisor of
    k'; b = 1 is exact GMM).  ``prep`` passes the sweep invariants of
    ``pts`` in (``core.gmm._sweep_points``; computed here when None).

    Returns per reducer: plain -> (points (l, k', d), valid (l, k'),
    radius (l,)); ext -> (delegates (l, k'·k, d), valid (l, k'·k), radius);
    gen -> (kernel points (l, k', d), multiplicity (l, k') int32, radius)."""
    from ..constrained.coreset import _grouped_delegates_impl

    n, d = pts.shape
    per = n // num_reducers
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, pts.device, metric_name)
    labels, starts = _reducer_labels(num_reducers, per, pts.device)
    if prep is None:
        prep = _sweep_points(pts, metric_name)
    idx, radius, _, _, _ = _schedule_select_impl(
        prep, pts, labels, starts, num_reducers, kprime,
        _round1_schedule(kprime, b, schedule), chunk, metric_name,
        use_pallas, grouped=True)
    if mode == "plain":
        valid = torch.ones((num_reducers, kprime), dtype=torch.bool,
                           device=pts.device)
        return pts[idx], valid, radius
    didx, dvalid, mult = _grouped_delegates_impl(
        pts, labels, idx, num_reducers, k, kprime, chunk, metric_name,
        use_pallas, prep=prep)
    if mode == "ext":
        # an invalid delegate slot holds zeros, not whatever row the
        # extraction left there, so it does not depend on the other groups
        return torch.where(dvalid[..., None], pts[didx], 0.0), dvalid, radius
    return pts[idx], mult, radius


def _reducer_units(pts, num_reducers: int, metric_name: str, round1):
    """``unit(i)``: reducer i's round 1 alone, ``round1(rows, prep, i)`` on
    its ``per`` rows and their slice of the sweep invariants (computed once
    over all rows, so each reducer sees the values the one-run path sees),
    inside an ``mr.reducer[i]`` span that waits for the device before it
    reads the clock.  The device is waited for with no trace on as well, so
    a ``StragglerPolicy`` timing the unit sees device time.  Returns
    (outputs, span or None)."""
    per = pts.shape[0] // num_reducers
    prep = _sweep_points(pts, metric_name)

    def unit(i):
        lo, hi = i * per, (i + 1) * per
        sub = Prepared(prep.points[lo:hi],
                       None if prep.xsq is None else prep.xsq[lo:hi])
        out = []
        with _span(f"mr.reducer[{i}]", sync=out, reducer=i) as sp:
            out.append(round1(pts[lo:hi], sub, i))
        _block(out)
        _count("device_dispatches")
        return out[0], sp
    return unit


def _merge_reducers(outs):
    return tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))


def _sim_round1_detail(num_reducers: int, unit):
    """Per-reducer observability path (``ExecutionSpec(trace="reducers")``):
    ``unit(i)`` (``_reducer_units``) once per reducer, so every reducer gets
    a span with its own device time.  The times feed
    ``distributed.fault_tolerance.StragglerPolicy`` (warmup-aware: reducer
    0 carries the kernel build) and flagged reducers land in the trace
    extras as ``mr_stragglers``.  ℓ launches a fold where the one-run path
    makes one: an observability mode, not a production path."""
    from ..distributed.fault_tolerance import StragglerPolicy

    policy = StragglerPolicy(min_history=3)
    outs, stragglers = [], []
    for i in range(num_reducers):
        out, sp = unit(i)
        outs.append(out)
        if sp is not None and policy.observe(sp.seconds):
            stragglers.append(i)
    tr = _obs_active()
    if tr is not None:
        tr.annotate(mr_stragglers=tuple(stragglers))
    return _merge_reducers(outs)


def _sim_round1_resilient(num_reducers: int, unit, policy):
    """Round 1 under a ``ResiliencePolicy``: ``unit(i)`` once per reducer,
    each an independently retryable unit.  Failed reducers
    (``on_failure="degrade"``) contribute an all-zeros block (``valid`` /
    multiplicity 0) — the merged layout is the one-run path's, and the
    composable core-set property keeps the surviving union a valid
    core-set of the surviving shards.  Returns the merged outputs plus the
    ``ResilienceReport``."""
    from ..distributed.fault_tolerance import run_resilient

    outs, report = run_resilient(num_reducers, lambda i: unit(i)[0], policy,
                                 scope="reducer")
    ok = [o for o in outs if o is not None]
    if not ok:
        raise RuntimeError(
            f"all {num_reducers} reducers failed under on_failure="
            f"{policy.on_failure!r}; nothing to merge")
    outs = [o if o is not None else tuple(torch.zeros_like(t) for t in ok[0])
            for o in outs]
    return _merge_reducers(outs) + (report,)


def _simulate_mr_impl(points, k: int, measure: str, *, num_reducers: int,
                      kprime=None, metric="euclidean",
                      generalized: bool = False,
                      partition: str = "contiguous",
                      seed: int = 0, b=1, chunk: int = 0, eps: float = 0.1,
                      tau=None, cliff=None, use_pallas="auto", device=None,
                      resilience=None):
    """Execution body of the simulated ℓ-reducer MR run (the
    ``repro_torch.diversify`` facade routes here).  Returns (sol (k, d)
    tensor on the points' device, value, cs, report) — ``report`` is the
    ``ResilienceReport`` when a ``ResiliencePolicy`` governed the run, else
    None."""
    if kprime is None:
        kprime = max(2 * k, 32)
    pts, shards, _ = partition_shards(points, num_reducers,
                                      partition=partition, seed=seed,
                                      device=device)
    d = pts.shape[1]
    per_shard = int(shards.shape[1])
    kprime, schedule, b, cert = _resolve_reducer_plan(
        pts, k, kprime, b, eps=eps, metric=metric, chunk=chunk,
        per_shard=per_shard, tau=tau, cliff=cliff, use_pallas=use_pallas)

    mode = ("gen" if generalized else
            "ext" if measure in NEEDS_INJECTIVE else "plain")
    if _counting():
        _count_round1(num_reducers, per_shard, d, kprime, b, schedule, mode)
    report = None
    with _round1_span(num_reducers, kprime,
                     _round1_schedule(kprime, b, schedule)):
        if resilience is not None or _reducer_detail():
            unit = _reducer_units(
                pts, num_reducers, get_metric(metric).name,
                lambda rows, prep, i: _sim_round1(
                    rows, 1, k, kprime, metric, mode, b, chunk, schedule,
                    use_pallas, prep=prep))
            if resilience is not None:
                g_pts, g_aux, g_rad, report = _sim_round1_resilient(
                    num_reducers, unit, resilience)
            else:
                g_pts, g_aux, g_rad = _sim_round1_detail(num_reducers, unit)
        else:
            g_pts, g_aux, g_rad = _sim_round1(pts, num_reducers, k, kprime,
                                              metric, mode, b, chunk,
                                              schedule, use_pallas)
            _count("device_dispatches")
    radius = torch.max(g_rad)
    degraded = report is not None and report.degraded
    if degraded:
        from ..distributed.fault_tolerance import degraded_certificate
        cert = degraded_certificate(cert, kprime=kprime,
                                    radius=float(radius),
                                    survivors=report.survivors,
                                    total=num_reducers, per_shard=per_shard)

    if generalized:
        # the reference re-dispatches round 1 for the integer
        # multiplicities (over the survivors only in a degraded run); here
        # they came from the same delegate pass, and its dispatch is
        # charged by the reference's model
        _count("device_dispatches")
        if degraded:
            keep = torch.as_tensor(report.survivors, device=g_pts.device)
            g_pts, g_aux, g_rad = g_pts[keep], g_aux[keep], g_rad[keep]
        cs = GeneralizedCoreset(points=g_pts.reshape(-1, d),
                                multiplicity=g_aux.reshape(-1),
                                radius=torch.max(g_rad), cert=cert)
        p, m = cs.compact()
        idx = solve(measure, p, k, weights=m, metric=metric)
        uniq, counts = np.unique(idx, return_counts=True)
        sol = instantiate(p[torch.as_tensor(uniq, device=p.device)], counts,
                          pts, float(cs.radius), metric=metric,
                          use_pallas=use_pallas)
    else:
        flat_valid = g_aux.reshape(-1)
        cs = Coreset(points=g_pts.reshape(-1, d), valid=flat_valid,
                     weights=flat_valid.to(torch.int32), radius=radius,
                     cert=cert)
        sol = solve_on_coreset(cs, k, measure, metric=metric)
    return sol, solution_value(sol, measure, metric), cs, report


def simulate_mr(points, k: int, measure: str, *, num_reducers: int,
                kprime=None, metric="euclidean",
                generalized: bool = False, partition: str = "contiguous",
                seed: int = 0, b=1, chunk: int = 0, eps: float = 0.1,
                tau=None, cliff=None, device="cuda"):
    """Simulate the ℓ-reducer 2-round MR run on one device.

    Legacy spelling of ``repro_torch.diversify`` with ``ExecutionSpec(
    mode="mapreduce", num_reducers=...)`` — prefer the facade for new code.
    ``partition``: 'contiguous' | 'random' | 'adversarial'; ``b="auto"`` /
    ``kprime="auto"`` probe once and freeze a static reducer schedule.
    Returns (solution_points (k, d) numpy, value)."""
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify

    _warn_legacy("repro_torch.core.distributed.simulate_mr")
    res = diversify(
        ProblemSpec(points=points, k=k, measure=measure, metric=metric),
        ExecutionSpec(mode="mapreduce", num_reducers=num_reducers,
                      kprime=kprime, b=b, chunk=chunk, eps=eps,
                      generalized=generalized, partition=partition,
                      seed=seed, tau=tau, cliff=cliff, device=device))
    return res.solution, res.value
