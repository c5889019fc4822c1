"""MapReduce diversity maximization, simulated on one device or on a mesh of
``torch.distributed`` ranks (paper §5, §6.2; port of
``repro.core.distributed``).

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

The mesh path (``mr_coreset``, ``_mr_diversity_impl``/``mr_diversity``,
``mr_coreset_recursive``) runs over ``torch.distributed``: one process a
reducer, the reducers being the ranks of a ``DeviceMesh`` over its data
axes.  Each rank runs round 1 on its own rows as the per-reducer unit
above (the grouped engine over one group, B4 a fold on the card) and
round 2 is one row all-gather of the per-rank core-sets, in the
reference's tiled order, plus a MAX reduction of the radius.  A
``b="auto"``/``kprime="auto"`` probe gathers the strided subsample from the
ranks' shards to the first reducer, which probes it and broadcasts its
frozen plan, so every rank runs the same schedule.  The three-round scheme
instantiates on the shards (each rank's first candidates a kernel point,
merged in global row order), and the recursive scheme gathers over
``data``, runs the level-2 exact GMM on every rank of a pod (B2 on the
card) and gathers over ``pod``.  On a contiguous partition with
ℓ | n the mesh union equals the simulated one at ``num_reducers=ℓ``.
Collectives stage through pinned host memory when the group's backend is
not NCCL (gloo ranks may keep their data on a card); a rank's failure in
round 1 is agreed on by every rank before the all-gather (a MAX
reduction of a failure flag), so the ranks raise, or retry under a
``ResiliencePolicy``, together.
"""
from __future__ import annotations

import collections
import weakref

import numpy as np
import torch

from ..device import as_points, is_dtensor, resolve_use_pallas, to_numpy
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

# --------------------------------------------------------------------------
# reducer plan + model counters
# --------------------------------------------------------------------------

def _resolve_reducer_plan(points, k: int, kprime, b, *, eps: float,
                          metric, chunk: int, per_shard: int,
                          labels=None, m: int = 1, tau=None, cliff=None,
                          use_pallas="auto", comm=None):
    """Freeze ``b="auto"``/``kprime="auto"`` into static reducer inputs.

    All reducers share one schedule, so a cheap probe
    (``core.adaptive.resolve_engine_plan``) runs once on a subsample of the
    global input (on the card, through the sweep kernels) and its decisions
    become every reducer's static (block, rounds) schedule.  k' is clamped
    to the shard size.  On a mesh (``comm``, the data-axes ranks) ``points``
    and ``labels`` are this rank's rows and the first reducer probes
    (``_probe_on_first``).  Returns (kprime:int, schedule|None, b:int,
    probe RadiusCertificate|None)."""
    if b != "auto" and kprime != "auto":
        return kprime, None, b, None
    from .adaptive import plan_from_schedule, resolve_engine_plan

    with _span("mr.probe", k=k, kprime=kprime, b=b):
        kw = dict(eps=eps, metric=metric, m=m, chunk=chunk,
                  use_pallas=use_pallas, tau=tau, cliff=cliff)
        if comm is None:
            kp, schedule, cert = resolve_engine_plan(
                points, k, kprime, b, labels=labels, **kw)
        else:
            kp, schedule, cert = _probe_on_first(comm, points, labels, k,
                                                 kprime, b, kw)
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


# --------------------------------------------------------------------------
# mesh path (torch.distributed)
# --------------------------------------------------------------------------

# id(mesh) -> {axes: flattened group}: a process group is made by a
# collective of every rank, so each is made once per mesh; the entry goes
# with its mesh (a finalizer), and no mesh or group is kept alive by it
_AXES_GROUPS = {}


def _axis_size(mesh, name: str) -> int:
    """Ranks along the named axis ``name`` of ``mesh`` (the reference's
    ``mesh.shape[name]``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"axis {name!r} is not an axis of the mesh "
                         f"(axes {names})")
    return int(mesh.size(names.index(name)))


def _axes_group(mesh, axes, dims, grid):
    """The process group of this rank's reducers over ``axes``: the mesh's
    own group for one axis, else one group per coordinate of the other
    axes, made once per (mesh, axes) by every rank in the same order."""
    import torch.distributed as dist

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if id(mesh) not in _AXES_GROUPS:
        _AXES_GROUPS[id(mesh)] = {}
        weakref.finalize(mesh, _AXES_GROUPS.pop, id(mesh), None)
    groups = _AXES_GROUPS[id(mesh)]
    if tuple(axes) not in groups:
        others = [i for i in range(grid.ndim) if i not in dims]
        lists = grid.permute(others + list(dims)).reshape(
            -1, int(np.prod([grid.shape[i] for i in dims]))).tolist()
        groups[tuple(axes)], _ = dist.new_subgroups_by_enumeration(lists)
    return groups[tuple(axes)]


def _pinned(t):
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


class _Comm:
    """The reducers of one mesh run: this rank's group over the data axes
    ``axes``, its members in the reference's tiled order (row-major mesh
    coordinates over ``axes`` in the order given, the other axes fixed at
    this rank's coordinates).  ``rank`` is this rank's place in that order
    and ``size`` the number of reducers ℓ.

    A collective runs on the data's device under NCCL and through pinned
    host memory under any other backend (gloo), decided by the group's
    backend; a collective that fails raises (the process group's timeout
    ends a hung one).  ``nbytes`` sums the bytes the gathers returned."""

    def __init__(self, mesh, axes):
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names or ())
        axes = tuple(axes)
        for a in axes:
            _axis_size(mesh, a)                      # raises on a bad axis
        dims = [names.index(a) for a in axes]
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not a member of the mesh")
        grid = mesh.mesh
        sub = grid[tuple(slice(None) if i in dims else coord[i]
                         for i in range(grid.ndim))]
        kept = sorted(dims)
        sub = sub.permute([kept.index(i) for i in dims])
        self.order = [int(r) for r in sub.reshape(-1).tolist()]
        self.size = len(self.order)
        self.rank = self.order.index(dist.get_rank())
        self.group = _axes_group(mesh, axes, dims, grid)
        members = dist.get_process_group_ranks(self.group)
        self._perm = [members.index(r) for r in self.order]
        self.backend = str(dist.get_backend(self.group))
        self.nbytes = 0

    def _host(self, t) -> bool:
        return t.is_cuda and "nccl" not in self.backend

    def _send(self, t):
        """``t`` as it goes on the wire (a bool as uint8), in pinned host
        memory when the backend cannot take it from the card."""
        wire = torch.uint8 if t.dtype == torch.bool else t.dtype
        src = t.contiguous().to(wire)
        host = self._host(src)
        return (_pinned(src) if host else src), host

    def _buffers(self, src, host):
        return [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                            pin_memory=host) for _ in range(self.size)]

    def _merge(self, outs, t):
        # each block to t's device, then one concatenation there (not on
        # the host, where it costs a pass over the gathered bytes)
        out = torch.cat([outs[i].to(t.device) for i in self._perm]).to(
            t.dtype)
        self.nbytes += out.numel() * out.element_size()
        return out

    def gather(self, t):
        """Every rank's ``t`` (one shape on all ranks), concatenated along
        dim 0 in the reducers' order."""
        import torch.distributed as dist

        src, host = self._send(t)
        outs = self._buffers(src, host)
        dist.all_gather(outs, src, group=self.group)
        return self._merge(outs, t)

    def gather_first(self, t):
        """``gather`` to the first reducer alone: the concatenation there,
        None on the other ranks."""
        import torch.distributed as dist

        src, host = self._send(t)
        first = self.rank == 0
        outs = self._buffers(src, host) if first else None
        dist.gather(src, outs, dst=self.order[0], group=self.group)
        return self._merge(outs, t) if first else None

    def max(self, x):
        """MAX over the ranks of the scalar tensor ``x``."""
        import torch.distributed as dist

        buf = x.reshape(1).clone()
        buf = buf.cpu() if self._host(buf) else buf
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(x.device).reshape(())

    def any(self, flag: bool, device) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        import torch.distributed as dist

        buf = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        buf = buf.cpu() if self._host(buf) else buf
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return bool(buf.item())

    def broadcast(self, obj):
        """The first reducer's ``obj`` (a picklable host value), on every
        rank."""
        import torch.distributed as dist

        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.order[0], group=self.group)
        return box[0]


def _local_rows(x, mesh, comm: _Comm, axes, n: int):
    """This rank's rows of ``x`` (points or labels): the local shard of a
    DTensor placed ``Shard(0)`` over the data axes (in mesh order) and
    replicated over the others, or block ``comm.rank`` of a full array
    every rank holds (the reference's single-controller view)."""
    per = n // comm.size
    if not is_dtensor(x):
        return x[comm.rank * per:(comm.rank + 1) * per]
    names = tuple(mesh.mesh_dim_names or ())
    dims = [names.index(a) for a in axes]
    if x.device_mesh != mesh:
        raise ValueError("the DTensor input lives on another mesh than the "
                         "run's mesh=")
    ok = dims == sorted(dims) and all(
        pl.is_shard(0) if i in dims else pl.is_replicate()
        for i, pl in enumerate(x.placements))
    if not ok:
        raise ValueError(
            f"a DTensor input must be Shard(0) over the data axes {axes} "
            f"(in mesh order) and replicated over the other axes; got "
            f"placements {tuple(x.placements)} on axes {names}")
    local = x.to_local()
    if local.shape[0] != per:
        raise ValueError(f"uneven shards: this rank holds {local.shape[0]} "
                         f"rows, {per} expected for n={n} over "
                         f"{comm.size} reducers")
    return local


def _mesh_setup(points, mesh, axes, device):
    """(comm, rows, n, d): the reducers over ``axes`` and this rank's rows
    as float32 on ``device``.  ``n % ℓ != 0`` raises, as in the reference
    (the mesh path pads nothing)."""
    comm = _Comm(mesh, axes)
    n, d = (int(s) for s in points.shape)
    if n % comm.size:
        raise ValueError(f"n={n} not divisible by {comm.size} reducers")
    return comm, as_points(_local_rows(points, mesh, comm, axes, n),
                           device), n, d


def _gather_probe_rows(comm: _Comm, rows, labels):
    """The probe's strided subsample ``points[::stride]`` of the global
    input and its labels (host ints, or None), gathered from the shards to
    the first reducer in global row order: rank r holds the sample rows
    r·per + i with i ≡ -r·per (mod stride).  (None, None) on the other
    ranks."""
    from .adaptive import probe_stride

    per = rows.shape[0]
    stride = probe_stride(per * comm.size)
    firsts = [(-r * per) % stride for r in range(comm.size)]
    counts = [len(range(f, per, stride)) for f in firsts]
    width = max(counts)

    def gather(x):
        part = x[firsts[comm.rank]::stride]
        pad = part.new_zeros((width - part.shape[0],) + tuple(part.shape[1:]))
        blocks = comm.gather_first(torch.cat([part, pad])[None])
        if blocks is None:
            return None
        return torch.cat([blocks[r, :counts[r]] for r in range(comm.size)])

    lab = None
    if labels is not None:
        lab = gather(torch.as_tensor(np.asarray(to_numpy(labels)),
                                     dtype=torch.int32, device=rows.device))
        lab = None if lab is None else to_numpy(lab)
    return gather(rows), lab


def _probe_on_first(comm: _Comm, rows, labels, k: int, kprime, b, kw):
    """The probe of a mesh run: the first reducer probes the gathered
    subsample (``adaptive.probe_engine_plan``) and broadcasts its frozen
    plan with the counters the probe added to its trace, which every other
    rank adds to its own; so every rank runs the same schedule and carries
    the same counters.  A probe that fails raises on every rank.  Returns
    (kprime, schedule|None, cert)."""
    from .adaptive import probe_engine_plan

    sub, lab = _gather_probe_rows(comm, rows, labels)
    msg = None
    if comm.rank == 0:
        tr = _obs_active()
        before = collections.Counter(tr.counters if tr is not None else {})
        try:
            plan = probe_engine_plan(sub, lab, k, kprime, b, **kw)
        except Exception as e:
            comm.broadcast((None, f"{type(e).__name__}: {e}"))
            raise
        after = collections.Counter(tr.counters if tr is not None else {})
        msg = (plan, dict(after - before))
    plan, delta = comm.broadcast(msg)
    if plan is None:
        raise RuntimeError(f"the probe failed on the first reducer: {delta}")
    if comm.rank != 0:
        for name, n in delta.items():
            _count(name, n)
    return plan


def _agree_round(comm: _Comm, run, policy, point: str, device):
    """Run this rank's local share of a round (``run()``, no collective) and
    agree with every rank on its outcome before any collective: a MAX
    reduction of a failure flag.  Without a policy every rank raises when
    any rank failed; under a ``ResiliencePolicy`` all ranks retry together
    (``retry_call``; ``degrade`` is retry-then-raise, as in the reference's
    mesh path, which has no per-reducer unit to drop).  Returns (outputs,
    ResilienceReport or None)."""
    from ..distributed.fault_tolerance import ResiliencePolicy, retry_call

    out, report = retry_call(
        run, policy or ResiliencePolicy(on_failure="raise"), point=point,
        agree=lambda failed: comm.any(failed, device))
    return out, None if policy is None else report


def _gather_round1(comm: _Comm, blocks, radius=None, **attrs):
    """Round 2's collective: every rank's round-1 ``blocks`` (leading dim 1)
    gathered in the reducers' order and flattened, plus the MAX of
    ``radius`` (when given), inside an ``mr.allgather`` span that records
    the bytes gathered."""
    before = comm.nbytes
    with _span("mr.allgather", reducers=comm.size, **attrs) as sp:
        out = tuple(comm.gather(t).flatten(0, 1) for t in blocks)
        rad = None if radius is None else comm.max(radius.max())
        if sp is not None:
            sp.attrs["bytes"] = comm.nbytes - before
    return out, rad


class _MeshRound(collections.namedtuple(
        "_MeshRound", "out report comm rows labels kprime b schedule cert "
        "per d")):
    """Round 1 of a mesh run on this rank (``_mesh_unit_round``): the
    unit's outputs, the ResilienceReport (or None), the reducers, this
    rank's rows and host labels (or None), and the frozen plan."""


def _mesh_unit_round(points, mesh, axes, unit, *, k: int, kprime, b,
                     eps: float, metric, chunk: int, tau, cliff, use_pallas,
                     device, resilience, point: str, labels=None,
                     m: int = 1, **span_attrs) -> _MeshRound:
    """Round 1 of a mesh run on this rank, the part every scheme shares:
    this rank's rows (and labels) over ``axes``, the reducer plan (the
    first reducer's probe), then ``unit(rows, labels, kprime, b,
    schedule)`` (the per-reducer unit, no collective) inside the
    ``mr.round1`` span, its outcome agreed by every rank
    (``_agree_round``, at resilience point ``point``)."""
    comm, rows, n, d = _mesh_setup(points, mesh, axes, device)
    lab = None
    if labels is not None:
        if not (is_dtensor(labels) or hasattr(labels, "shape")):
            labels = np.asarray(labels)
        lab = np.asarray(to_numpy(_local_rows(labels, mesh, comm, axes, n)),
                         np.int32)
    per = n // comm.size
    kprime, schedule, b, cert = _resolve_reducer_plan(
        rows, k, kprime, b, eps=eps, metric=metric, chunk=chunk,
        per_shard=per, labels=lab, m=m, tau=tau, cliff=cliff,
        use_pallas=use_pallas, comm=comm)
    with _round1_span(comm.size, kprime,
                     _round1_schedule(kprime, b, schedule), **span_attrs):
        out, report = _agree_round(
            comm, lambda: unit(rows, lab, kprime, b, schedule), resilience,
            point, rows.device)
    return _MeshRound(out, report, comm, rows, lab, kprime, b, schedule,
                      cert, per, d)


def _mesh_round1(points, k: int, kprime, measure: str, mesh, *, axes,
                 metric, use_pallas, generalized: bool, b, chunk: int,
                 eps: float, tau, cliff, device, resilience):
    """Rounds 1 and 2 of the two-round scheme on this rank.  Returns
    (union Coreset | GeneralizedCoreset, report, comm, rows)."""
    mode = ("gen" if generalized else
            "ext" if measure in NEEDS_INJECTIVE else "plain")
    r = _mesh_unit_round(
        points, mesh, axes,
        lambda rows, _, kp, b_, sched: _sim_round1(
            rows, 1, k, kp, metric, mode, b_, chunk, sched, use_pallas),
        k=k, kprime=kprime, b=b, eps=eps, metric=metric, chunk=chunk,
        tau=tau, cliff=cliff, use_pallas=use_pallas, device=device,
        resilience=resilience, point="round:mr.round1")
    if _counting():
        _count("device_dispatches")
        _count_round1(r.comm.size, r.per, r.d, r.kprime, r.b, r.schedule,
                      mode)
    (g_pts, g_aux), radius = _gather_round1(r.comm, r.out[:2], r.out[2])
    if generalized:
        cs = GeneralizedCoreset(points=g_pts, multiplicity=g_aux,
                                radius=radius, cert=r.cert)
    else:
        cs = Coreset(points=g_pts, valid=g_aux,
                     weights=g_aux.to(torch.int32), radius=radius,
                     cert=r.cert)
    return cs, r.report, r.comm, r.rows


def mr_coreset(points, k: int, kprime, measure: str, mesh, *,
               data_axes=("data",), metric="euclidean", use_pallas="auto",
               generalized: bool = False, b=1, chunk: int = 0,
               eps: float = 0.1, tau=None, cliff=None, device=None):
    """2-round MR core-set on a mesh, called by every rank of ``mesh``.
    ``points`` is globally (n, d): a DTensor placed ``Shard(0)`` over
    ``data_axes``, or the same full array on every rank (each rank takes
    its contiguous rows).  Returns the union T = ∪ T_i as a
    Coreset/GeneralizedCoreset, the same on every rank, on ``device``
    (default: the points' device, the card for host arrays).  ``b``/
    ``chunk`` tune the per-reducer engine; ``b="auto"``/``kprime="auto"``
    probe once and freeze every reducer's schedule."""
    return _mesh_round1(points, k, kprime, measure, mesh,
                        axes=tuple(data_axes), metric=metric,
                        use_pallas=use_pallas, generalized=generalized, b=b,
                        chunk=chunk, eps=eps, tau=tau, cliff=cliff,
                        device=device, resilience=None)[0]


def _mesh_instantiate(comm: _Comm, kpts, counts, rows, radius: float, *,
                      metric, use_pallas):
    """Round 3 of the generalized scheme on the mesh:
    ``sequential.instantiate`` against the global input, whose rows lie on
    the ranks.  Since the counts sum to k, a kernel point's first ``cnt``
    unused rows within the radius lie among its first k global candidates,
    hence among the ranks' first k local ones: each rank finds those (one
    B3 column a kernel point on its shard), the ranks gather them, and
    every rank replays the reference's loop on the merged lists in global
    row order; the chosen rows come back with one more gather."""
    from .sequential import _within_radius

    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    per, dev = rows.shape[0], rows.device
    base = comm.rank * per
    cand = torch.full((len(counts), total), -1, dtype=torch.int64,
                      device=dev)
    for j, (_, hits) in enumerate(_within_radius(rows, kpts, radius,
                                                 metric=metric,
                                                 use_pallas=use_pallas)):
        first = torch.nonzero(hits).flatten()[:total]
        cand[j, :first.shape[0]] = first + base
    merged = to_numpy(comm.gather(cand[None]))      # (ℓ, u, total)
    used, rows_of, kernel_of = set(), [], []
    for j, cnt in enumerate(counts):
        take = []
        for r in merged[:, j].reshape(-1):
            if len(take) == cnt:
                break
            if r >= 0 and int(r) not in used:
                take.append(int(r))
        used.update(take)
        rows_of += take + [-1] * (int(cnt) - len(take))
        kernel_of += [j] * int(cnt)
    g = torch.as_tensor(rows_of, dtype=torch.int64, device=dev)
    owner = torch.where(g >= 0, g // per, -1)
    mine = owner == comm.rank
    block = torch.zeros((total, rows.shape[1]), dtype=rows.dtype,
                        device=dev)
    block[mine] = rows[g[mine] - base]
    got = comm.gather(block[None])                   # (ℓ, total, d)
    picked = got[owner.clamp(min=0), torch.arange(total, device=dev)]
    kpts = torch.as_tensor(kpts, dtype=torch.float32, device=dev)
    fallback = kpts[torch.as_tensor(kernel_of, dtype=torch.int64,
                                    device=dev)]
    return torch.where((g >= 0)[:, None], picked, fallback)


def _mesh_match_rows(comm: _Comm, rows, sol, k: int, *, row_labels=None,
                     sol_labels=None) -> np.ndarray:
    """``data.selection._match_rows`` against the global input whose rows
    lie on the ranks.  Each rank sends, for every solution point, its
    first rows in (distance, row) order — as many as there are solution
    points, enough since fewer rows than that are ever taken — and every
    rank replays the sequential first-argmin pick on the merged lists in
    global row order."""
    from ..data.selection import _row_distances

    dist = _row_distances(rows, sol, row_labels=row_labels,
                          sol_labels=sol_labels)
    top = min(rows.shape[0], dist.shape[1])
    vals, idx = torch.sort(dist, dim=0, stable=True)
    gv = to_numpy(comm.gather(vals[:top]))
    gi = to_numpy(comm.gather(idx[:top] + comm.rank * rows.shape[0]))
    taken, picks = set(), []
    for t in range(gv.shape[1]):
        for o in np.argsort(gv[:, t], kind="stable"):
            if not np.isfinite(gv[o, t]):
                break
            if int(gi[o, t]) not in taken:
                taken.add(int(gi[o, t]))
                picks.append(int(gi[o, t]))
                break
    return np.asarray(picks[:k], np.int64)


def _mr_diversity_impl(points, k: int, measure: str, mesh, *, kprime=None,
                       data_axes=("data",), metric="euclidean",
                       use_pallas="auto", three_round: bool = False, b=1,
                       chunk: int = 0, eps: float = 0.1, tau=None,
                       cliff=None, resilience=None, device=None):
    """Execution body of the mesh MR pipeline, run by every rank (the
    ``repro_torch.diversify`` facade routes here).  Returns (sol (k, d)
    tensor, value, cs, report), the same on every rank.  A
    ``ResiliencePolicy`` retries round 1 on all ranks together."""
    if kprime is None:
        kprime = max(2 * k, 32)
    cs, report, comm, rows = _mesh_round1(
        points, k, kprime, measure, mesh, axes=tuple(data_axes),
        metric=metric, use_pallas=use_pallas, generalized=three_round, b=b,
        chunk=chunk, eps=eps, tau=tau, cliff=cliff, device=device,
        resilience=resilience)
    if not three_round:
        sol = solve_on_coreset(cs, k, measure, metric=metric)
    else:
        pts, mult = cs.compact()
        idx = solve(measure, pts, k, weights=mult, metric=metric)
        uniq, counts = np.unique(idx, return_counts=True)
        # round 3: instantiate the chosen multiset against the input
        sol = _mesh_instantiate(
            comm, pts[torch.as_tensor(uniq, device=pts.device)], counts,
            rows, float(cs.radius), metric=metric, use_pallas=use_pallas)
    return sol, solution_value(sol, measure, metric), cs, report


def mr_diversity(points, k: int, measure: str, mesh, *, kprime=None,
                 data_axes=("data",), metric="euclidean",
                 use_pallas="auto", three_round: bool = False, b=1,
                 chunk: int = 0, eps: float = 0.1, tau=None, cliff=None,
                 device="cuda"):
    """Full pipeline on a mesh: 2-round (Thm 6) or 3-round generalized
    (Thm 10), called by every rank.

    Legacy spelling of ``repro_torch.diversify`` with ``ExecutionSpec(
    mode="mapreduce", mesh=...)`` — prefer the facade for new code.
    Returns (solution_points (k, d) numpy, value)."""
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify

    _warn_legacy("repro_torch.core.distributed.mr_diversity")
    res = diversify(
        ProblemSpec(points=points, k=k, measure=measure, metric=metric),
        ExecutionSpec(mode="mapreduce", mesh=mesh,
                      data_axes=tuple(data_axes), kprime=kprime, b=b,
                      chunk=chunk, eps=eps, use_pallas=use_pallas,
                      three_round=three_round, tau=tau, cliff=cliff,
                      device=device))
    return res.solution, res.value


def _recursive_level2(pod_pts, pod_mask, kprime: int, metric_name: str,
                      use_pallas):
    """Level 2 of the recursive scheme on a pod's union: exact GMM (b = 1,
    the B2 sweep on the card) over its valid rows, uncounted as in the
    reference (whose body runs inside ``shard_map``).  Returns (the
    level-2 core-set (k', d), its radius)."""
    from .gmm import _as_mask, _gmm_impl

    res = _gmm_impl(_sweep_points(pod_pts, metric_name),
                    _as_mask(pod_mask, pod_pts), 0, kprime, metric_name,
                    resolve_use_pallas(use_pallas, pod_pts.device,
                                       metric_name))
    return pod_pts[res.idx], res.radius


def _mesh_recursive(points, k: int, kprime, measure: str, mesh, *, metric,
                    use_pallas, b, chunk: int, eps: float, tau, cliff,
                    device, resilience):
    """Thm 8 on this rank.  Returns (Coreset of the pods' level-2 unions,
    report, comm, rows)."""
    if "pod" not in tuple(mesh.mesh_dim_names or ()):
        raise ValueError("recursive scheme expects a 'pod' axis")
    mode = "ext" if measure in NEEDS_INJECTIVE else "plain"
    r = _mesh_unit_round(
        points, mesh, ("pod", "data"),
        lambda rows, _, kp, b_, sched: _sim_round1(
            rows, 1, k, kp, metric, mode, b_, chunk, sched, use_pallas),
        k=k, kprime=kprime, b=b, eps=eps, metric=metric, chunk=chunk,
        tau=tau, cliff=cliff, use_pallas=use_pallas, device=device,
        resilience=resilience, point="round:mr.recursive")
    within, across = _Comm(mesh, ("data",)), _Comm(mesh, ("pod",))
    pts, mask, radius = r.out
    # level 1: the union within the pod
    (pod_pts, pod_mask), _ = _gather_round1(within, (pts, mask), level=1)
    with _span("mr.level2", sync=pod_pts, kprime=r.kprime):
        lvl2, lvl2_radius = _recursive_level2(
            pod_pts, pod_mask, r.kprime, get_metric(metric).name, use_pallas)
    # level 2: the union across pods
    (g_pts,), _ = _gather_round1(across, (lvl2[None],), level=2)
    g_rad = r.comm.max(torch.maximum(radius.max(), lvl2_radius))
    m = g_pts.shape[0]
    cs = Coreset(points=g_pts,
                 valid=torch.ones((m,), dtype=torch.bool, device=g_pts.device),
                 weights=torch.ones((m,), dtype=torch.int32,
                                    device=g_pts.device),
                 radius=g_rad, cert=r.cert)
    return cs, r.report, r.comm, r.rows


def mr_coreset_recursive(points, k: int, kprime, measure: str, mesh, *,
                         metric="euclidean", use_pallas="auto", b=1,
                         chunk: int = 0, eps: float = 0.1, tau=None,
                         cliff=None, device=None):
    """Thm 8: two-level reduction, called by every rank — per-rank core-sets
    gathered over ``data``, re-contracted by an exact GMM on every rank of
    a pod, then gathered over ``pod`` (requires a ('pod', 'data', ...)
    mesh).  ``points`` as in ``mr_coreset``, sharded over both axes."""
    return _mesh_recursive(points, k, kprime, measure, mesh, metric=metric,
                           use_pallas=use_pallas, b=b, chunk=chunk, eps=eps,
                           tau=tau, cliff=cliff, device=device,
                           resilience=None)[0]
