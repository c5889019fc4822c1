"""GMM (Gonzalez' greedy k-center) and the paper's extensions (port of
``repro.core.gmm``).

``gmm``       — the kernel construction of Lemma 5 / Thm 4 (remote-edge/cycle).
``gmm_ext``   — kernel + up-to-(k-1) delegates per cluster (Lemma 6 / Thm 5).
``gmm_gen``   — kernel + multiplicities: generalized core-sets (Lemma 8 / Thm 10).

Each GMM round is one fused pass over the points: distance to the newest
center block, running min and the masked top-p (argmax for b=1).  With
``use_pallas`` resolved to True (the default on a CUDA device) the pass is
the hand-written CUDA sweep (``kernels.ops.gmm_topb`` / ``gmm_update_select``);
otherwise it is the plain torch version of the same function.  The loop
invariants of a run — squared norms, and for cosine the normalized points —
are computed once per run (``kernels.ops.prepare``), not once per sweep.

PyTorch runs eagerly, so the reference's ``fori_loop``/``lax.map`` bodies
are Python loops over device tensors; no loop here reads a device value on
the host.  Index tensors are int64.  Invalid points are handled with
``mask`` (their field value is pinned to −inf, so they are never selected).
The selection engine is generic over m groups: m = 1 is the unconstrained
sweep (B1/B2), m > 1 the constrained engine's grouped sweep (B4,
``kernels.ops.grouped_gmm_topb``), where each point folds only its own
group's centers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import as_points, resolve_use_pallas
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs.trace import (count as _count, counting as _counting,
                         sweep_bytes as _sweep_bytes)
from .coreset import GeneralizedCoreset
from .metrics import get_metric

NEG_INF = float("-inf")


class GMMResult(NamedTuple):
    idx: torch.Tensor       # (k,) selected indices into points
    radius: torch.Tensor    # () — max_p d(p, T)  (range r_T of the returned set)
    min_dist: torch.Tensor  # (n,) — d(p, T) for every point
    assign: torch.Tensor    # (n,) index (into 0..k-1) of nearest center
    sel_dist: torch.Tensor  # (k,) — distance of each center to the prefix before it
                            #        (anticover distances; sel_dist[0] = +inf)


def _sweep_points(points, metric_name: str) -> kops.Prepared:
    """The run's sweep invariants.  Metrics without a kernel mode
    (manhattan) sweep the raw points through the plain metric."""
    if metric_name in ("euclidean", "sqeuclidean", "cosine"):
        return kops.prepare(points, metric_name)
    return kops.Prepared(points, None)


def _sweep_dist(prep: kops.Prepared, centers, metric_name: str):
    """Plain torch distance of every prepared point to its nearest center
    in ``centers`` (rows of ``prep.points``)."""
    if metric_name in ("euclidean", "sqeuclidean", "cosine"):
        d = kref.sweep_dist_ref(prep.points, centers, metric_name,
                                xsq=prep.xsq)
    else:
        d = get_metric(metric_name).pairwise(prep.points, centers)
    return d.min(dim=1).values


def _fold(prep, cidx, min_dist, mask, metric_name: str, p: int,
          use_pallas: bool):
    """One sweep: fold the centers ``prep.points[cidx]`` into the field and
    return (min_dist, top-p values, top-p indices)."""
    centers = prep.points.index_select(0, cidx)
    if use_pallas:
        return kops.gmm_topb(prep.points, centers, min_dist, mask,
                             metric_name, p=p, xsq=prep.xsq, prepared=True)
    new, masked = kref.masked_field(
        min_dist, _sweep_dist(prep, centers, metric_name), mask)
    vals, idx = kref.topk_stable(masked, p)
    return new, vals, idx


def _gmm_impl(prep, mask, start: int, k: int, metric_name: str,
              use_pallas: bool) -> GMMResult:
    x = prep.points
    n, dev = x.shape[0], x.device
    idx = torch.zeros((k,), dtype=torch.int64, device=dev)
    idx[0] = start
    min_dist = torch.full((n,), float("inf"), device=dev)
    assign = torch.zeros((n,), dtype=torch.int64, device=dev)
    sel_dist = torch.full((k,), float("inf"), device=dev)
    radius = None
    for i in range(1, k + 1):
        # distance from all points to the center chosen at step i-1, fused
        # running min + masked argmax (one sweep on the kernel path)
        center = x.index_select(0, idx[i - 1:i])
        if use_pallas:
            new, j, jmax = kops.gmm_update_select(
                x, center, min_dist, mask, metric_name, xsq=prep.xsq,
                prepared=True)
        else:
            new, masked = kref.masked_field(
                min_dist, _sweep_dist(prep, center, metric_name), mask)
            j = torch.argmax(masked)
            jmax = kref.take(masked, j)
        assign = torch.where(new < min_dist, i - 1, assign)
        if i < k:
            idx[i:i + 1] = j.reshape(1)
            sel_dist[i:i + 1] = jmax.reshape(1)
        min_dist, radius = new, jmax
    # min_dist/assign include the k-th center and ``radius`` is the masked
    # max after the final update (= r_T).
    return GMMResult(idx=idx, radius=radius, min_dist=min_dist, assign=assign,
                     sel_dist=sel_dist)


def _ones_mask(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=device)


def _as_mask(mask, points) -> torch.Tensor:
    if mask is None:
        return _ones_mask(points.shape[0], points.device)
    return torch.as_tensor(mask, dtype=torch.bool, device=points.device)


def gmm(points, k: int, *, metric="euclidean", mask=None, start=0,
        use_pallas="auto", device=None) -> GMMResult:
    """Run GMM(points, k).  Returns indices + anticover telemetry.

    The returned set satisfies the anticover property: r_T <= sel_dist[k-1]
    <= rho_T, which Fact 1 of the paper builds on.
    """
    points = as_points(points, device)
    n = points.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for n={n}")
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, points.device, metric_name)
    mask = _as_mask(mask, points)
    if _counting():
        _count("device_dispatches")
        _count("distance_evals", n * k)
        _count("bytes_swept", _sweep_bytes(n, points.shape[1], sweeps=k))
    return _gmm_impl(_sweep_points(points, metric_name), mask, int(start), k,
                     metric_name, use_pallas)


# --------------------------------------------------------------------------
# the single-sweep selection engine (schedule-driven, generic over m groups)
# --------------------------------------------------------------------------

def _make_grouped_sweep(prep, labels, m: int, p: int, chunk: int,
                        metric_name: str, use_pallas: bool,
                        grouped: bool = False):
    """Build the fused sweep closure ``sweep(min_dist, cidx)``: fold the
    center block ``prep.points[cidx]`` ((m, bc) int64 indices, bc centers
    per group) into the shared running-min field and extract every group's
    top-``p`` candidates ((m, p) values and indices).

    A point folds only its OWN group's bc centers (the per-group GMM runs
    are independent), so the field stays (n,) and a sweep costs n·bc·d
    distance work.  ``m == 1`` is the unconstrained sweep (B1/B2 on the
    kernel path); ``m > 1`` the grouped one (B4), whose plain version
    computes the (n, m·bc) block with the kernel's arithmetic
    (``kref.grouped_dist_ref``) and keeps each row's own part.  Rows with
    label < 0 can never be selected.  ``grouped=True`` takes the grouped
    sweep for m = 1 too (a per-reducer or one-request run then computes
    what its group computes in a run of many groups).  The centers' squared
    norms are the run's (``prep.xsq`` gathered), not recomputed per sweep,
    so a distance never depends on the other groups of the sweep.
    ``chunk`` is unused: the kernels mask the ragged tile themselves and
    the plain sweeps take the whole array."""
    if m == 1 and not grouped:
        mask = labels >= 0

        def sweep(min_dist, cidx):
            md, cd, ci = _fold(prep, cidx[0], min_dist, mask, metric_name,
                               p, use_pallas)
            return md, cd[None, :], ci[None, :]
        return sweep

    x = prep.points

    def sweep(min_dist, cidx):
        bc = cidx.shape[1]
        flat = cidx.reshape(-1)
        centers = x.index_select(0, flat)
        csq = None if prep.xsq is None else prep.xsq.index_select(0, flat)
        if use_pallas:
            return kops.grouped_gmm_topb(
                x, centers.view(m, bc, -1), min_dist, labels, metric_name, p,
                xsq=prep.xsq, csq=csq, prepared=True)
        if metric_name in ("euclidean", "sqeuclidean", "cosine"):
            dist = kref.grouped_dist_ref(x, centers, metric_name,
                                         xsq=prep.xsq, ysq=csq)
        else:
            dist = get_metric(metric_name).pairwise(x, centers)
        return kref.grouped_field(dist, min_dist, labels, m, p)
    return sweep


def _pool_distance(metric_name: str, pool):
    """The in-block GMM's distance from every pool member to one picked
    member per group: returns ``f(c)`` mapping (m, d) picks to (m, p)
    distances for the (m, p, d) pools.  One group (the unconstrained
    engine) keeps the metric's own ``point_to_set``; the grouped engine
    takes ``_pool_matrix`` for the kernel metrics, and this batched form
    (manhattan) or a loop over the groups otherwise."""
    metric = get_metric(metric_name)
    if pool.shape[0] == 1:
        return lambda c: metric.point_to_set(pool[0], c[0])[None]
    if metric_name == "manhattan":
        return lambda c: torch.sum(torch.abs(pool - c[:, None, :]), dim=-1)
    return lambda c: torch.stack([metric.point_to_set(pool[g], c[g])
                                  for g in range(pool.shape[0])])


def _pool_matrix(prep, metric_name: str, cand_i):
    """(m, p, p) distances within every group's candidate pool, with the
    B3 kernel's arithmetic on the run's prepared rows: each dot product
    summed in float64 and rounded once, the epilogue in float32 with the
    run's squared norms.  An entry depends on its two rows only, so a
    group's in-block picks are the same however many groups share the run.
    Groups go through in slices that keep the float64 pool under 2^25
    entries."""
    m, p = cand_i.shape
    flat = cand_i.reshape(-1)
    pool = prep.points.index_select(0, flat).view(m, p, -1)
    step = max(1, (1 << 25) // max(1, p * pool.shape[2]))
    dot = torch.cat([torch.bmm(c64, c64.transpose(1, 2)).to(torch.float32)
                     for c64 in (c.to(torch.float64)
                                 for c in pool.split(step))])
    if metric_name == "cosine":
        return torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sq = prep.xsq.index_select(0, flat).view(m, p)
    d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, min=0.0)
    return torch.sqrt(d2) if metric_name == "euclidean" else d2


def _grouped_inblock(points, metric_name: str, cand_d, cand_i, take: int,
                     prep=None):
    """Exact local GMM over every group's candidate pool (p×p): greedily
    keep ``take`` of the p candidates, correcting for mutual distances
    within the pool.  Returns (chosen (m, take), seld (m, take)) where
    ``seld[g, j]`` is pick j's corrected anticover distance.  Each pick is
    one (m, p) argmax / gather / min over all groups at once, on the
    device: no host read, and launches per block do not grow with m.

    With ``prep`` (the grouped engine's runs) the pool distances come from
    ``_pool_matrix`` on the prepared rows, so a group's picks depend on its
    own pool alone; without it (the unconstrained engine) from the metric's
    ``point_to_set``."""
    m, p = cand_d.shape
    dev = cand_d.device
    rows = torch.arange(m, device=dev)
    if prep is not None and metric_name in ("euclidean", "sqeuclidean",
                                            "cosine"):
        dist_to = None
    else:
        pool = points.index_select(0, cand_i.reshape(-1)).view(m, p, -1)
        dist_to = _pool_distance(metric_name, pool)
    dm = None
    cd = cand_d.clone()
    chosen = torch.zeros((m, take), dtype=torch.int64, device=dev)
    seld = torch.zeros((m, take), dtype=torch.float32, device=dev)
    for j in range(take):
        s = torch.argmax(cd, dim=1, keepdim=True)
        chosen[:, j:j + 1] = torch.gather(cand_i, 1, s)
        seld[:, j:j + 1] = torch.gather(cd, 1, s)
        if j + 1 == take:
            break                   # the last pick's distances go unused
        if dist_to is not None:
            dd = dist_to(pool[rows, s[:, 0]])
        else:
            if dm is None:
                dm = _pool_matrix(prep, metric_name, cand_i)
            dd = dm[rows, s[:, 0]]
        cd = torch.minimum(cd, dd).scatter_(1, s, NEG_INF)
    return chosen, seld


def validate_schedule(schedule, k: int):
    """A schedule is a tuple of (block, rounds) phases covering k picks."""
    total = 0
    for b, r in schedule:
        if b < 1 or r < 1:
            raise ValueError(f"bad schedule phase {(b, r)}")
        total += b * r
    if total != k:
        raise ValueError(f"schedule {schedule} covers {total} picks, not {k}")
    return tuple((int(b), int(r)) for b, r in schedule)


def schedule_sweep_counts(schedule):
    """Centers folded into the field at each sweep of ``schedule`` — the
    x-axis of the radius trajectory the engine emits (the final entry is the
    full selection, whose field max is the measured anticover radius)."""
    counts = []
    pos = 0
    for pi, (b, r) in enumerate(schedule):
        if pi == 0 and b > 1:
            counts.append(1)                      # seed sweep
        elif pi > 0:
            counts.append(pos)                    # transition sweep
        counts.extend(pos + t * b for t in range(1, r))
        pos += r * b
    counts.append(pos)                            # final fold
    return tuple(counts)


def schedule_fold_sizes(schedule):
    """Centers folded into the field BY each sweep (companion to
    ``schedule_sweep_counts``; same length).  ``n x sum(fold_sizes)`` is the
    engine's exact distance-evaluation count for the schedule."""
    folds = []
    for pi, (b, r) in enumerate(schedule):
        if pi == 0 and b > 1:
            folds.append(1)                       # seed sweep
        elif pi > 0:
            folds.append(schedule[pi - 1][0])     # transition sweep
        folds.extend([b] * (r - 1))
    folds.append(schedule[-1][0])                 # final fold
    return tuple(folds)


def _schedule_select_impl(prep, points, labels, starts, m: int, k: int,
                          schedule, chunk: int, metric_name: str,
                          use_pallas: bool, grouped: bool = False):
    """All ``m`` per-group GMM runs in lock-step under a selection schedule.

    Phase (b, r) selects r blocks of b centers each; b > 1 sweeps oversample
    4b candidates per group and an exact in-block GMM keeps the best b
    (block 0 lookahead-fills slots 1..b-1 from the seed sweep's pool).
    b = 1 is exact sequential GMM.  ``grouped=True`` runs the grouped sweep
    and in-block arithmetic at m = 1 too (see ``_make_grouped_sweep``), so
    one group alone picks what it picks among many.

    Returns (idx (m, k), radius (m,), min_dist (n,), traj (S, m),
    bcd (S-1, m)) where S = len(schedule_sweep_counts(schedule)).
    """
    n, dev = points.shape[0], points.device
    S = len(schedule_sweep_counts(schedule))
    idx = torch.zeros((m, k), dtype=torch.int64, device=dev)
    idx[:, 0] = starts
    md = torch.full((n,), float("inf"), device=dev)
    traj = torch.full((S, m), float("inf"), device=dev)
    bcd = torch.full((S - 1, m), float("inf"), device=dev)
    sweeps = {}

    def get_sweep(p):
        if p not in sweeps:
            sweeps[p] = _make_grouped_sweep(prep, labels, m, p, chunk,
                                            metric_name, use_pallas, grouped)
        return sweeps[p]

    inprep = prep if (m > 1 or grouped) else None

    sc = 0          # sweep counter
    pos = 0         # picks committed
    for pi, (b, r) in enumerate(schedule):
        p = min(4 * b, n) if b > 1 else 1
        sweep = get_sweep(p)
        if pi == 0 and b > 1:
            # seed sweep: fold the per-group seeds, lookahead-fill 1..b-1
            md, cd, ci = sweep(md, idx[:, 0:1])
            traj[sc] = cd[:, 0]
            chosen, seld = _grouped_inblock(points, metric_name, cd, ci, b,
                                            prep=inprep)
            idx[:, 1:b] = chosen[:, :b - 1]
            bcd[sc] = seld[:, :b - 1].min(dim=1).values
            sc += 1
        elif pi > 0:
            # transition sweep: fold the previous phase's pending block
            prev_b = schedule[pi - 1][0]
            md, cd, ci = sweep(md, idx[:, pos - prev_b:pos])
            traj[sc] = cd[:, 0]
            chosen, seld = _grouped_inblock(points, metric_name, cd, ci, b,
                                            prep=inprep)
            idx[:, pos:pos + b] = chosen
            bcd[sc] = seld.min(dim=1).values
            sc += 1
        for t in range(1, r):
            md, cd, ci = sweep(md, idx[:, pos + (t - 1) * b:pos + t * b])
            si = sc + t - 1
            traj[si] = cd[:, 0]
            chosen, seld = _grouped_inblock(points, metric_name, cd, ci, b,
                                            prep=inprep)
            idx[:, pos + t * b:pos + (t + 1) * b] = chosen
            bcd[si] = seld.min(dim=1).values
        sc += max(r - 1, 0)
        pos += r * b

    # final fold: the per-group masked max IS the anticover radius r_T
    last_b = schedule[-1][0]
    md, cd, _ = get_sweep(1)(md, idx[:, k - last_b:k])
    traj[S - 1] = cd[:, 0]
    return idx, cd[:, 0], md, traj, bcd


def effective_block(k: int, b: int) -> int:
    """Largest selection-block size <= b that divides k (the engines select
    whole center blocks, so k must split into blocks)."""
    if b <= 1:
        return 1
    return b if k % b == 0 else math.gcd(k, b)


def _adjust_chunk(n: int, chunk: int) -> int:
    """Clamp a chunk knob to the point count (0 -> whole array)."""
    if not chunk:
        return n
    return max(min(chunk, n), 1)


def _pad_to_chunk(n: int, chunk: int):
    """Rows of padding needed so chunk divides the point count."""
    return -(-n // chunk) * chunk - n


def pad_for_engine(points, labels, chunk: int):
    """Snap ``chunk`` to the point count and pad (points, labels) so that it
    divides n — pad rows carry label -1, which matches no group.  The
    port's sweeps do not need this (the CUDA kernel masks the ragged tile,
    the plain sweep takes the whole array); it is kept for callers that
    tile by hand.  ``chunk=0`` defaults to 4096-row tiles."""
    n = points.shape[0]
    ch = _adjust_chunk(n, chunk or 4096)
    pad = _pad_to_chunk(n, ch)
    if pad:
        points = torch.cat([points, points.new_zeros((pad, points.shape[1]))])
        labels = torch.cat([labels, labels.new_full((pad,), -1)])
    return points, labels, ch


def mask_to_labels(mask):
    """Unconstrained masks as engine labels: valid rows are group 0, masked
    rows carry the sentinel label -1 (never selectable)."""
    return torch.where(mask, 0, -1).to(torch.int32)


class ScheduleResult(NamedTuple):
    idx: torch.Tensor       # (k,) selected indices
    radius: torch.Tensor    # () — measured anticover radius r_T
    min_dist: torch.Tensor  # (n,) — d(p, T) for every point
    counts: tuple           # centers folded at each sweep
    traj: torch.Tensor      # (S,) — anticover radius at each sweep
    margins: torch.Tensor   # (S-1,) — per-block min corrected pick distance
    schedule: tuple         # the executed (block, rounds) phases


def gmm_schedule(points, k: int, schedule, *, metric="euclidean", mask=None,
                 start=0, chunk: int = 0, use_pallas="auto",
                 device=None) -> ScheduleResult:
    """Run the selection engine under an explicit (block, rounds) schedule
    and return the full radius telemetry (trajectory + greedy-consistency
    margins)."""
    points = as_points(points, device)
    n = points.shape[0]
    schedule = validate_schedule(schedule, k)
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, points.device, metric_name)
    labels = mask_to_labels(_as_mask(mask, points))
    if _counting():
        folds = schedule_fold_sizes(schedule)
        _count("device_dispatches")
        _count("distance_evals", n * sum(folds))
        _count("bytes_swept",
               _sweep_bytes(n, points.shape[1], sweeps=len(folds)))
    idx, radius, min_dist, traj, bcd = _schedule_select_impl(
        _sweep_points(points, metric_name), points, labels, int(start), 1, k,
        schedule, chunk, metric_name, use_pallas)
    return ScheduleResult(idx=idx[0], radius=radius[0], min_dist=min_dist,
                          counts=schedule_sweep_counts(schedule),
                          traj=traj[:, 0], margins=bcd[:, 0],
                          schedule=schedule)


def gmm_batched(points, k: int, *, b=8, metric="euclidean", mask=None,
                start=0, chunk: int = 0, use_pallas="auto",
                schedule=None, sprint="auto", device=None):
    """Batched GMM: ``b`` centers per sweep (4b-candidate oversampling plus
    an exact in-block correction), so a full run costs k/b + 1 sweeps; b=1
    is exact sequential GMM and ``b="auto"`` runs the radius-certified
    adaptive controller (``core.adaptive``).  ``schedule`` overrides ``b``
    with an explicit (block, rounds) phase plan.  Without a schedule, k
    must be a multiple of b.  Returns (idx, radius, min_dist)."""
    if b == "auto" and schedule is None:
        from .adaptive import gmm_adaptive
        res = gmm_adaptive(points, k, metric=metric, mask=mask, start=start,
                           chunk=chunk, use_pallas=use_pallas, sprint=sprint,
                           device=device)
        return res.idx, res.radius, res.min_dist
    if schedule is None:
        if k % b:
            raise ValueError(f"k={k} must be a multiple of b={b}")
        schedule = ((b, k // b),)
    res = gmm_schedule(points, k, schedule, metric=metric, mask=mask,
                       start=start, chunk=chunk, use_pallas=use_pallas,
                       device=device)
    return res.idx, res.radius, res.min_dist


class GMMExtResult(NamedTuple):
    kernel_idx: torch.Tensor     # (k',) kernel (center) indices
    delegate_idx: torch.Tensor   # (k', k) indices; row j = center j + delegates
    delegate_valid: torch.Tensor # (k', k) bool
    multiplicity: torch.Tensor   # (k',) int32 = min(|C_j|, k)   (GMM-GEN output)
    radius: torch.Tensor         # () kernel range r_T'
    assign: torch.Tensor         # (n,) nearest-kernel-center assignment


def delegates_from_assign(idx, assign, mask, k: int, kprime: int):
    """Delegate extraction: given the kernel ``idx`` (k',) and a
    nearest-kernel-center ``assign`` (n,), compute the per-cluster delegate
    table.

    Returns (cand (k', k), valid (k', k), mult (k',), assign (n,)) where
    ``assign`` has invalid rows rerouted to the sentinel cluster k' and each
    center forced into its own cluster.
    """
    n, dev = assign.shape[0], assign.device
    assign = torch.where(mask, assign, kprime)  # invalid -> sentinel cluster
    # force each center into its own cluster (ties at distance 0 could have
    # attached it to an earlier co-located center)
    assign = assign.index_put((idx,), torch.arange(kprime, device=dev))

    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=kprime + 1)[:kprime]
    starts = torch.searchsorted(sorted_assign,
                                torch.arange(kprime, device=dev))

    # delegate slot t of cluster j = order[starts[j] + t], valid while t < count
    t_grid = torch.arange(k, device=dev)[None, :]
    gather_pos = torch.clamp(starts[:, None] + t_grid, 0, n - 1)
    cand = order[gather_pos]
    valid = t_grid < counts[:, None]

    # force-include the center in slot 0; a duplicate of it elsewhere in the
    # row is masked out
    cand[:, 0] = idx
    dup0 = (cand == idx[:, None]) & (t_grid > 0)
    valid = valid & ~dup0
    valid[:, 0] = counts > 0

    mult = torch.minimum(counts, torch.tensor(k, device=dev)).to(torch.int32)
    return cand, valid, mult, assign


def _assign_to_centers(points, idx, chunk: int, metric_name: str,
                       use_pallas: bool = False):
    """Nearest-selected-center index for every point, in row chunks of a
    (chunk, k') distance tile; the (n, k') matrix never materializes.  With
    ``use_pallas`` the tiles are the B3 kernel's (``kernels.ops.pairwise``,
    on rows prepared once); otherwise the plain metric."""
    n = points.shape[0]
    if _counting():
        _count("device_dispatches")
        _count("distance_evals", n * int(idx.shape[0]))
        _count("bytes_swept", _sweep_bytes(n, points.shape[1]))
    ch = _adjust_chunk(n, chunk or 4096)
    out = torch.empty((n,), dtype=torch.int64, device=points.device)
    if use_pallas:
        prep = kops.prepare(points, metric_name)
        cidx = idx.to(points.device)
        centers = prep.points.index_select(0, cidx)
        csq = None if prep.xsq is None else prep.xsq.index_select(0, cidx)
        for s in range(0, n, ch):
            xsq = None if prep.xsq is None else prep.xsq[s:s + ch]
            out[s:s + ch] = torch.argmin(kops.pairwise(
                prep.points[s:s + ch], centers, metric_name, xsq=xsq,
                ysq=csq, prepared=True), dim=1)
        return out
    metric = get_metric(metric_name)
    centers = points.index_select(0, idx)
    for s in range(0, n, ch):
        out[s:s + ch] = torch.argmin(metric.pairwise(points[s:s + ch],
                                                     centers), dim=1)
    return out


def gmm_ext(points, k: int, kprime: int, *, metric="euclidean", mask=None,
            start=0, use_pallas="auto", b=1, chunk: int = 0, schedule=None,
            device=None) -> GMMExtResult:
    """GMM-EXT (Algorithm 1): kernel of k' centers + up to k-1 delegates each.

    ``b > 1`` selects the kernel with the batched lookahead-b engine,
    ``b="auto"`` with the adaptive controller and ``schedule`` with an
    explicit phase plan; all recover the assignment with one extra chunked
    argmin pass.
    """
    points = as_points(points, device)
    mask = _as_mask(mask, points)
    metric_name = get_metric(metric).name
    if b != "auto" and schedule is None:
        b = effective_block(kprime, b)
    if b == "auto" or schedule is not None or b > 1 or chunk:
        idx, radius, _ = gmm_batched(points, kprime, b=b, metric=metric,
                                     mask=mask, start=start, chunk=chunk,
                                     use_pallas=use_pallas, schedule=schedule)
        assign = _assign_to_centers(
            points, idx, chunk, metric_name,
            resolve_use_pallas(use_pallas, points.device, metric_name))
    else:
        res = gmm(points, kprime, metric=metric, mask=mask, start=start,
                  use_pallas=use_pallas)
        idx, radius, assign = res.idx, res.radius, res.assign
    cand, valid, mult, assign = delegates_from_assign(idx, assign, mask, k,
                                                      kprime)
    return GMMExtResult(kernel_idx=idx, delegate_idx=cand,
                        delegate_valid=valid, multiplicity=mult,
                        radius=radius, assign=assign)


def gmm_ext_from_kernel(points, idx, radius, k: int, *, metric="euclidean",
                        mask=None, chunk: int = 0, use_pallas="auto",
                        device=None) -> GMMExtResult:
    """Delegate extraction for an already-selected kernel ``idx`` (k',): one
    chunked argmin pass recovers the assignment (through the B3 kernel when
    ``use_pallas`` resolves to it), then the shared delegate table is
    built."""
    points = as_points(points, device)
    mask = _as_mask(mask, points)
    metric_name = get_metric(metric).name
    idx = torch.as_tensor(idx, dtype=torch.int64, device=points.device)
    kprime = int(idx.shape[0])
    assign = _assign_to_centers(
        points, idx, chunk, metric_name,
        resolve_use_pallas(use_pallas, points.device, metric_name))
    cand, valid, mult, assign = delegates_from_assign(idx, assign, mask, k,
                                                      kprime)
    return GMMExtResult(kernel_idx=idx, delegate_idx=cand,
                        delegate_valid=valid, multiplicity=mult,
                        radius=torch.as_tensor(radius, device=points.device),
                        assign=assign)


def gmm_gen(points, k: int, kprime: int, *, metric="euclidean", mask=None,
            start=0, use_pallas="auto", b=1, chunk: int = 0, schedule=None,
            device=None) -> GeneralizedCoreset:
    """GMM-GEN: generalized core-set of size s(T)=k', expanded size <= k·k'."""
    points = as_points(points, device)
    ext = gmm_ext(points, k, kprime, metric=metric, mask=mask, start=start,
                  use_pallas=use_pallas, b=b, chunk=chunk, schedule=schedule)
    return GeneralizedCoreset(points=points[ext.kernel_idx],
                              multiplicity=ext.multiplicity,
                              radius=ext.radius)
