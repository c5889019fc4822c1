"""Radius-certified adaptive selection: auto-tuned lookahead blocks (b) and
accuracy-targeted core-set sizing (k') (port of ``repro.core.adaptive``).

* **Adaptive b** (``gmm_adaptive`` / ``adaptive_select``): every sweep
  measures the exact anticover radius (the masked field max) and every
  in-block pick its corrected anticover distance; the controller keeps only
  the picks that clear the tau/cliff greedy-consistency bars and falls back
  to a b=1 continuation of plain GMM when blocks stop paying.
* **Auto k'** (``auto_kprime``): grow the selection geometrically (then by
  a secant step on the measured ratio curve) and stop when
  ``ratio = 2·r_T(k')/scale_k`` meets the accuracy target.

Each step's sweep is the CUDA kernel on the card (``use_pallas="auto"``)
or the plain torch sweep.  The host reads device data only where the
reference does: one packed readback per supervised block, the fold radius,
the resume's picks and radii.  Sprint mode runs post-certified segments in
one host loop that reads a single ``full`` flag per round (a device-paced
CUDA-graph version is later work); its picks, trajectory, executed
schedule and certificate are bit-identical to ``sprint=False``.
``plan_from_schedule``/``resolve_engine_plan`` freeze a probe run into the
static (block, rounds) schedule the MapReduce reducers share.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_points, resolve_use_pallas, to_numpy
from ..obs.trace import (count as _count, counting as _counting,
                         span as _span, sweep_bytes as _sweep_bytes)
from .gmm import (_as_mask, _grouped_inblock, _make_grouped_sweep,
                  _sweep_points, mask_to_labels, validate_schedule)
from .metrics import get_metric

# Greedy-consistency bars of the adaptive-b controller (see
# ``adaptive_select``); every entry point accepts per-call overrides.
DEFAULT_TAU = 0.15
DEFAULT_CLIFF = 0.35


def resolve_bars(tau: Optional[float],
                 cliff: Optional[float]) -> Tuple[float, float]:
    """Fill in the module-default tau/cliff bars for None overrides."""
    return (DEFAULT_TAU if tau is None else float(tau),
            DEFAULT_CLIFF if cliff is None else float(cliff))


def resolve_sprint(sprint, gamma: float = 0.0) -> bool:
    """Resolve the sprint knob ("auto" | True | False | None).

    Sprint is bit-identical to host pacing except under a nonzero
    cross-block ``gamma`` margin, whose block-halving decision is
    host-paced by design: ``"auto"``/None enable it exactly when
    ``gamma == 0``; ``True`` insists and raises on a conflicting ``gamma``;
    ``False`` keeps every block host-paced.
    """
    if sprint == "auto" or sprint is None:
        return gamma == 0.0
    if sprint and gamma != 0.0:
        raise ValueError(
            "sprint=True requires gamma=0: the cross-block gamma margin is "
            "a per-block host decision the fused segment cannot replay")
    return bool(sprint)


# --------------------------------------------------------------------------
# certificate container
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RadiusCertificate:
    """Measured evidence that a core-set meets its radius/accuracy target.

    ``radius`` is the exact anticover radius r_T of the selection, ``scale``
    the anticover radius after the first k picks (a measured lower bound on
    the optimal diversity scale, paper Fact 1), and ``ratio = 2·radius/scale``
    the certified additive-relative core-set error bound for the remote
    measures.  ``counts``/``radii`` is the per-sweep radius trajectory and
    ``b_schedule`` the (block, rounds) phases the engine executed.  The
    remaining fields mirror the reference's degradation and dynamic-index
    accounting, which the ported batch path leaves at their defaults.
    """
    kprime: int
    radius: float
    scale: float
    ratio: float
    eps_target: Optional[float] = None
    meets_target: Optional[bool] = None
    counts: Tuple[int, ...] = ()
    radii: Tuple[float, ...] = ()
    b_schedule: Tuple[Tuple[int, int], ...] = ()
    kind: str = "batch"
    group_ratios: Optional[Tuple[float, ...]] = None
    degraded: bool = False
    surviving_shards: Optional[Tuple[int, ...]] = None
    total_shards: Optional[int] = None
    points_covered: Optional[int] = None
    points_total: Optional[int] = None
    updates_since_rebuild: Optional[int] = None
    deletions_absorbed: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def auto_milestones(k: int, n: int, kprime_max=None):
    """The geometric auto-k' growth plan: start at max(2k, 32), double up to
    the cap (default max(256, 16k), clamped to n).  Returns
    (kmax, milestones); kmax itself is the implicit final milestone."""
    kmax = min(n, kprime_max if kprime_max else max(256, 16 * k))
    kmax = max(kmax, min(k, n))
    first = min(kmax, max(2 * k, 32))
    miles, c = [], first
    while c < kmax:
        miles.append(c)
        c *= 2
    return kmax, miles


def _secant_next(hist, eps: Optional[float], cur: int, cap: int) -> int:
    """Next auto-k' milestone: a secant step on the measured (k', ratio)
    curve in log-log space once two milestone measurements exist, clamped
    to the geometric x2 step as both the first move and the overshoot cap.

    >>> _secant_next([(32, 0.8), (64, 0.4)], 0.3, 64, 1024)
    86
    >>> _secant_next([(32, 0.8), (64, 0.4)], 0.1, 64, 1024)   # capped at x2
    128
    >>> _secant_next([(32, 0.4)], 0.1, 32, 1024)              # x2 first step
    64
    """
    fallback = min(2 * cur, cap)
    if eps is None or eps <= 0 or len(hist) < 2:
        return fallback
    (k1, r1), (k2, r2) = hist[-2], hist[-1]
    if not (k2 > k1 > 0 and 0.0 < r2 < r1 and np.isfinite(r1)):
        return fallback
    slope = (np.log(r2) - np.log(r1)) / (np.log(k2) - np.log(k1))
    if not np.isfinite(slope) or slope >= 0:
        return fallback
    est = k2 * (eps / r2) ** (1.0 / slope)
    if not np.isfinite(est):
        return fallback
    return int(np.clip(np.ceil(est), cur + 1, fallback))


def _ratio(radius: float, scale: float) -> float:
    if radius <= 0.0:
        return 0.0
    if scale <= 0.0 or not np.isfinite(scale):
        return float("inf")
    return 2.0 * radius / scale


def certificate_from_trajectory(counts: Sequence[int],
                                radii: Sequence[float], k: int,
                                *, eps: Optional[float] = None,
                                b_schedule=(), kind: str = "batch",
                                group_ratios=None) -> RadiusCertificate:
    """Build the certificate from a (counts, radii) trajectory: the scale is
    the first radius sample with >= k centers folded."""
    counts = tuple(int(c) for c in counts)
    radii = tuple(float(r) for r in radii)
    radius = radii[-1] if radii else float("inf")
    scale = next((r for c, r in zip(counts, radii) if c >= k), radius)
    ratio = _ratio(radius, scale)
    return RadiusCertificate(
        kprime=counts[-1] if counts else 0, radius=radius, scale=scale,
        ratio=ratio, eps_target=eps,
        meets_target=None if eps is None else bool(ratio <= eps),
        counts=counts, radii=radii,
        b_schedule=tuple(tuple(x) for x in b_schedule), kind=kind,
        group_ratios=group_ratios)


# --------------------------------------------------------------------------
# engine steps (shared by the host-paced loop and the sprint segments)
# --------------------------------------------------------------------------

def _fold_impl(prep, labels, min_dist, pending, m: int, p: int, chunk: int,
               metric_name: str, use_pallas: bool):
    """Fold the pending center block (an (m, bp) index block) into the
    field and surface each group's top-p candidate pool.  ``cd[:, 0]`` is
    the exact anticover radius of the selection folded so far."""
    sweep = _make_grouped_sweep(prep, labels, m, p, chunk, metric_name,
                                use_pallas)
    return sweep(min_dist, pending)


def _block_step_impl(prep, points, labels, min_dist, pending, m: int,
                     take: int, p: int, chunk: int, metric_name: str,
                     use_pallas: bool):
    """One supervised engine block: fold the pending centers, pull the
    oversampled pool, run the exact in-block GMM for ``take`` tentative
    picks.  Returns (min_dist, chosen (m, take), stats (m, take+1)) where
    ``stats[:, 0]`` is the exact anticover radius of everything folded so
    far and ``stats[:, 1:]`` the tentative picks' corrected anticover
    distances — packed so the host reads one tensor per block."""
    sweep = _make_grouped_sweep(prep, labels, m, p, chunk, metric_name,
                                use_pallas)
    md, cd, ci = sweep(min_dist, pending)
    chosen, seld = _grouped_inblock(points, metric_name, cd, ci, take,
                                    prep=prep if m > 1 else None)
    return md, chosen, torch.cat([cd[:, :1], seld], dim=1)


def _sprint_impl(prep, points, labels, min_dist, pending, counts, pos0: int,
                 rmax: int, tau: float, cliff: float, m: int, b: int, p: int,
                 rcap: int, chunk: int, metric_name: str, use_pallas: bool):
    """Sprint segment: up to ``rmax`` full lookahead blocks, each round
    folding the previously committed block, sampling the exact radius,
    running the pooled in-block GMM for ``b`` tentative picks and applying
    the host controller's tau/cliff bars in float32 on the device (the
    arithmetic the host applies to ``stats_np``, so the commit decision is
    bit-identical).  A certified block commits and becomes the next fold; a
    block failing a bar past pick 0 is not committed and its stats/picks
    spill to the host, which truncates it exactly as a host-paced block.

    The loop reads one flag per round on the host.  Returns
    ``(rounds, truncated, min_dist, pending, blocks (rcap, m, b),
    traj (rcap, m), spill_stats (m, b+1), spill_chosen (m, b), reads)``.
    """
    dev = min_dist.device
    sweep = _make_grouped_sweep(prep, labels, m, p, chunk, metric_name,
                                use_pallas)
    tau_t = torch.tensor(tau, dtype=torch.float32, device=dev)
    cliff_t = torch.tensor(cliff, dtype=torch.float32, device=dev)
    blocks = torch.zeros((rcap, m, b), dtype=torch.int64, device=dev)
    traj = torch.zeros((rcap, m), dtype=torch.float32, device=dev)
    spill_stats = torch.zeros((m, b + 1), dtype=torch.float32, device=dev)
    spill_chosen = torch.zeros((m, b), dtype=torch.int64, device=dev)
    md, pend = min_dist, pending
    r, truncated, reads = 0, False, 0
    while r < rmax:
        md, cd, ci = sweep(md, pend)
        rnow = cd[:, 0]
        traj[r] = rnow
        chosen, seld = _grouped_inblock(points, metric_name, cd, ci, b,
                                        prep=prep if m > 1 else None)
        # the host controller's truncation test, verbatim: every pick past
        # the first must clear tau*radius AND cliff*previous-pick in every
        # group that still has fresh points, else the block truncates
        active = counts > (pos0 + r * b)
        thr = tau_t * torch.clamp(rnow, min=0.0)
        above_tau = seld >= thr[:, None]
        no_cliff = torch.cat(
            [torch.ones((m, 1), dtype=torch.bool, device=dev),
             seld[:, 1:] >= cliff_t * seld[:, :-1]], dim=1)
        ok = (~active[:, None]) | (above_tau & no_cliff)
        bad = ~torch.all(ok, dim=0)
        bad[0] = False
        full = bool(~torch.any(bad))        # the round's one host read
        reads += 1
        if not full:
            spill_stats = torch.cat([cd[:, :1], seld], dim=1)
            spill_chosen = chosen
            truncated = True
            break
        blocks[r] = chosen
        pend = chosen
        r += 1
    return (r, truncated, md, pend, blocks, traj, spill_stats, spill_chosen,
            reads)


def _resume_impl(prep, labels, min_dist, idx, start: int, end: int, m: int,
                 kcap: int, chunk: int, metric_name: str, use_pallas: bool):
    """Exact b=1 continuation of plain GMM from a live engine state: picks
    columns [start, end).  Entry invariant: columns < start are selected
    and all but the last are folded (re-folding a folded column is a
    no-op).  Returns (min_dist, idx, tcol) with tcol[r] = the per-group
    anticover radius measured when column r was picked."""
    sweep = _make_grouped_sweep(prep, labels, m, 1, chunk, metric_name,
                                use_pallas)
    tcol = torch.full((kcap, m), float("inf"), device=min_dist.device)
    md = min_dist
    for r in range(start, end):
        md, cd, ci = sweep(md, idx[:, r - 1:r])
        idx[:, r:r + 1] = ci
        tcol[r] = cd[:, 0]
    return md, idx, tcol


# --------------------------------------------------------------------------
# the host-paced adaptive loop (generic over m groups; m=1 == unconstrained)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveRun:
    """Raw outcome of ``adaptive_select`` (device tensors + host telemetry)."""
    idx: np.ndarray            # (m, ksel) selections
    ksel: int                  # centers selected per group
    radius: np.ndarray         # (m,) measured anticover radius
    min_dist: torch.Tensor     # (n,) final field (device)
    counts: Tuple[int, ...]    # trajectory x-axis (centers folded)
    traj: np.ndarray           # (S, m) per-group radius at each sample
    schedule: Tuple[Tuple[int, int], ...]  # executed (block, rounds) phases
    shrink_at: Tuple[int, ...]  # positions where the controller shrank b


def _compress_schedule(takes: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    phases = []
    for t in takes:
        if phases and phases[-1][0] == t:
            phases[-1][1] += 1
        else:
            phases.append([t, 1])
    return tuple((b, r) for b, r in phases)


def adaptive_select(points, labels, starts, m: int, k_cap: int, *,
                    b0: int = 8, gamma: float = 0.0,
                    tau: Optional[float] = None,
                    cliff: Optional[float] = None,
                    chunk: int = 0, metric: str = "euclidean",
                    use_pallas="auto",
                    milestones: Sequence[int] = (), eps: Optional[float] = None,
                    scale_count: Optional[int] = None,
                    group_counts=None, sprint="auto",
                    device=None) -> AdaptiveRun:
    """Adaptive engine: one fused fold+pool+pick step per supervised block
    and a few-scalar certificate check on the host (see the reference's
    docstring for the controller's three adaptations: within-block
    truncation by ``tau``/``cliff``, pool widening 16b -> 32b on heavy
    truncation, the optional cross-block ``gamma`` margin).  Two
    consecutive single-pick blocks switch to ``_resume_impl``, an exact b=1
    continuation.  With ``milestones`` and ``eps`` the loop stops at the
    first milestone whose measured certificate ratio meets ``eps`` (the
    ``auto_kprime`` growth loop); an unmet milestone re-plans the next one
    with ``_secant_next``.  The loop is generic over ``m`` groups (m = 1
    is the unconstrained engine): a block truncates when a group that still
    has fresh points (``group_counts`` above the picks so far) fails a bar,
    and a milestone is met when every inhabited, unfinished group meets
    ``eps``.
    """
    tau, cliff = resolve_bars(tau, cliff)
    points = as_points(points, device)
    dev = points.device
    labels = torch.as_tensor(labels, dtype=torch.int32, device=dev)
    n = points.shape[0]
    metric_name = get_metric(metric).name
    use_pallas = resolve_use_pallas(use_pallas, dev, metric_name)
    prep = _sweep_points(points, metric_name)
    counts_np = (np.asarray(group_counts, np.int64)
                 if group_counts is not None else np.full((m,), n, np.int64))
    k_cap = max(1, min(k_cap, n))
    starts_np = np.asarray(starts, np.int64)
    sprint_on = resolve_sprint(sprint, gamma)
    counts_dev = torch.as_tensor(np.minimum(counts_np, 2 ** 31 - 1),
                                 device=dev)

    idx_host = np.zeros((m, k_cap), np.int64)
    idx_host[:, 0] = starts_np
    md = torch.full((n,), float("inf"), device=dev)
    b_cur = max(1, min(b0, k_cap))
    pending = torch.as_tensor(starts_np, device=dev)[:, None]
    pending_folded = False
    pos = 1
    traj_counts, traj_vals, takes, shrink_at = [], [], [], []
    prev_margin = prev_active = None
    ones_streak = 0
    miles = sorted(c for c in set(int(x) for x in milestones) if c < k_cap)
    mile_hist: list = []     # (k', worst certified ratio) per unmet milestone
    scale = None
    stopped = False
    last_rnow = None

    def milestone_eval(rnow):
        """(met, worst ratio) across inhabited, unfinished groups."""
        if eps is None or scale is None:
            return False, float("inf")
        alive = counts_np > 0
        done = counts_np <= pos
        ratios = np.array([_ratio(float(r), float(s))
                           for r, s in zip(rnow, scale)])
        live = alive & ~done
        if not live.any():
            return True, 0.0
        worst = float(ratios[live].max())
        return bool(worst <= eps), worst

    def observe(rnow):
        nonlocal scale, stopped, miles
        traj_counts.append(pos)
        traj_vals.append(rnow)
        if scale is None and scale_count is not None and pos >= scale_count:
            scale = rnow.copy()
        crossed = False
        while miles and pos >= miles[0]:
            miles.pop(0)
            crossed = True
        if not crossed:
            return
        met, worst = milestone_eval(rnow)
        if met:
            stopped = True
        elif eps is not None:
            if np.isfinite(worst) and worst > 0.0:
                mile_hist.append((pos, worst))
            nxt = _secant_next(mile_hist, eps, pos, k_cap)
            miles = [nxt] if nxt < k_cap else []

    d = int(points.shape[1])

    def _step_obs(folded: int, sweeps: int = 1, syncs: int = 1) -> None:
        """One controller round-trip: ``sweeps`` sweeps folding ``folded``
        centers total, read back with ``syncs`` blocking transfers."""
        _count("device_dispatches")
        _count("host_syncs", syncs)
        _count("distance_evals", n * folded)
        _count("bytes_swept", _sweep_bytes(n, d, sweeps=sweeps, m=m))

    def commit_block(chosen, chosen_np, stats_np, take):
        """Host bookkeeping for one evaluated block — shared verbatim by the
        supervised path and the sprint spill replay, so a rolled-back block
        truncates bit-identically to a host-paced one.  Keeps the prefix of
        picks that clear BOTH bars in every group that still has fresh
        points: tau x the current radius and cliff x the previous pick."""
        nonlocal b_cur, ones_streak, p_mult, pending, pending_folded, pos, \
            prev_active, prev_margin
        rnow = stats_np[:, 0]
        active = counts_np > pos
        if prev_margin is not None and np.any(
                prev_active & (prev_margin
                               < gamma * np.maximum(rnow, 0.0))):
            b_cur = max(1, b_cur // 2)
            shrink_at.append(pos)
        seld_np = stats_np[:, 1:]
        thr = np.float32(tau) * np.maximum(rnow, np.float32(0.0))
        above_tau = seld_np >= thr[:, None]
        no_cliff = np.ones_like(above_tau)
        if take > 1:
            no_cliff[:, 1:] = seld_np[:, 1:] >= np.float32(cliff) \
                * seld_np[:, :-1]
        ok = ~active[:, None] | (above_tau & no_cliff)
        take_eff = take
        for j in range(1, take):
            if not ok[:, j].all():
                take_eff = j
                break
        idx_host[:, pos:pos + take_eff] = chosen_np[:, :take_eff]
        pending = chosen[:, :take_eff]
        prev_margin = np.min(
            np.where(active[:, None], seld_np[:, :take_eff], np.inf),
            axis=1)
        prev_active = active
        takes.append(take_eff)
        pending_folded = False
        pos += take_eff
        # pool adaptation: heavy truncation -> widen; full blocks -> relax
        if take_eff <= take // 2:
            if p_mult < 32:
                _count("pool_widenings")
            p_mult = min(32, p_mult * 2)
        elif take_eff == take:
            p_mult = max(16, p_mult // 2)
        if take_eff == 1:
            ones_streak += 1
            if ones_streak >= 2 and b_cur > 1:
                b_cur = 1
                shrink_at.append(pos)
        else:
            ones_streak = 0
        return take_eff

    def sprint_segment():
        """Segment runner: the next full b_cur-blocks up to the next
        milestone observe / k_cap, or to the first truncation.  Committed
        blocks are replayed into the host bookkeeping from the readback; a
        truncated block spills through ``commit_block``.  Returns False when
        the remaining segment is too short (< 2 full blocks)."""
        nonlocal md, pending, pending_folded, last_rnow, pos, \
            prev_active, prev_margin, ones_streak
        bseg = b_cur
        rmax = (k_cap - pos) // bseg
        if miles:
            if pos >= miles[0]:
                return False
            # observes land at pos, pos+b, ...: stay strictly below the
            # milestone so its eval (stop / secant re-plan) runs host-paced
            rmax = min(rmax, (miles[0] - 1 - pos) // bseg + 1)
        if rmax < 2:
            return False
        p = min(p_mult * bseg, n)
        rcap = max(1, k_cap // bseg)
        with _span("adaptive.sprint", pos=pos, b=bseg, rmax=int(rmax)):
            (rounds, truncated, md2, _pend, blocks_dev, traj_dev,
             spill_stats_dev, spill_chosen_dev, reads) = _sprint_impl(
                prep, points, labels, md, pending, counts_dev, pos, rmax,
                tau, cliff, m, bseg, p, rcap, chunk, metric_name, use_pallas)
            traj_seg = to_numpy(traj_dev)
            blocks_seg = to_numpy(blocks_dev)
        md = md2
        if _counting():
            folds = rounds + (1 if truncated else 0)
            _count("sprint_segments")
            # one flag read per round, then the packed segment readback
            _step_obs(folded=folds * bseg, sweeps=folds, syncs=reads + 1)
        for r in range(rounds):
            rnow = traj_seg[r]
            pending_folded, last_rnow = True, rnow
            observe(rnow)
            idx_host[:, pos:pos + bseg] = blocks_seg[r]
            takes.append(bseg)
            pos += bseg
        if rounds:
            pending = blocks_dev[rounds - 1]
            pending_folded = False
            prev_margin = prev_active = None
            ones_streak = 0
        if truncated:
            stats_np = to_numpy(spill_stats_dev)
            rnow = stats_np[:, 0]
            pending_folded, last_rnow = True, rnow
            observe(rnow)
            if not stopped:
                commit_block(spill_chosen_dev, to_numpy(spill_chosen_dev),
                             stats_np, bseg)
        return True

    p_mult = 16
    while pos < k_cap and not stopped:
        if b_cur > 1:
            take = min(b_cur, k_cap - pos)
            p = min(p_mult * b_cur, n)
            with _span("adaptive.block", pos=pos, b=b_cur, p=p):
                md, chosen, stats = _block_step_impl(
                    prep, points, labels, md, pending, m, take, p, chunk,
                    metric_name, use_pallas)
                stats_np = to_numpy(stats)    # the one blocking transfer
            if _counting():
                _step_obs(folded=int(pending.shape[1]))
            rnow = stats_np[:, 0]
            pending_folded, last_rnow = True, rnow
            observe(rnow)
            if stopped:
                break
            take_eff = commit_block(chosen, to_numpy(chosen), stats_np, take)
            # a fully-certified opening block hands the segment to the
            # sprint runner: the pool just relaxed to 16b and the streak
            # reset, so the controller state is stable until the boundary
            if (sprint_on and b_cur > 1 and take_eff == take == b_cur
                    and p_mult == 16 and pos < k_cap):
                sprint_segment()
        else:
            # exact b=1 tail, one resume per milestone segment
            if not pending_folded:
                with _span("adaptive.fold", pos=pos):
                    md, cd, _ = _fold_impl(prep, labels, md, pending, m, 1,
                                           chunk, metric_name, use_pallas)
                    rnow = to_numpy(cd[:, 0])
                if _counting():
                    _step_obs(folded=int(pending.shape[1]))
                pending_folded, last_rnow = True, rnow
                observe(rnow)
                if stopped:
                    break
            end = k_cap
            for c in miles:
                if c > pos:
                    end = min(end, c)
                    break
            with _span("adaptive.resume", start=pos, end=end):
                idx_dev = torch.as_tensor(idx_host, device=dev)
                md, idx_dev, tcol = _resume_impl(
                    prep, labels, md, idx_dev, max(pos, 1), end, m, k_cap,
                    chunk, metric_name, use_pallas)
                idx_host = to_numpy(idx_dev)
                tc = to_numpy(tcol)
            if _counting():
                seg = max(end - pos, 1)
                _step_obs(folded=seg, sweeps=seg)
            for r in range(pos, end):
                traj_counts.append(r)
                traj_vals.append(tc[r])
                if scale is None and scale_count is not None \
                        and r >= scale_count:
                    scale = tc[r].copy()
            takes.extend([1] * (end - pos))
            prev_margin = prev_active = None
            pending = idx_dev[:, end - 1:end]
            pending_folded = False
            pos = end
            if miles and pos >= miles[0]:
                with _span("adaptive.fold", pos=pos):
                    md, cd, _ = _fold_impl(prep, labels, md, pending, m, 1,
                                           chunk, metric_name, use_pallas)
                    rnow = to_numpy(cd[:, 0])
                if _counting():
                    _step_obs(folded=int(pending.shape[1]))
                pending_folded, last_rnow = True, rnow
                observe(rnow)

    # final fold: the measured anticover radius of everything selected
    if not pending_folded:
        with _span("adaptive.fold", pos=pos):
            md, cd, _ = _fold_impl(prep, labels, md, pending, m, 1, chunk,
                                   metric_name, use_pallas)
            rfin = to_numpy(cd[:, 0])
        if _counting():
            _step_obs(folded=int(pending.shape[1]))
        traj_counts.append(pos)
        traj_vals.append(rfin)
    else:
        rfin = last_rnow

    return AdaptiveRun(idx=idx_host[:, :pos], ksel=pos,
                       radius=rfin, min_dist=md,
                       counts=tuple(traj_counts),
                       traj=np.stack(traj_vals, axis=0),
                       schedule=_compress_schedule(takes),
                       shrink_at=tuple(shrink_at))


# --------------------------------------------------------------------------
# unconstrained front-ends
# --------------------------------------------------------------------------

class AdaptiveGMMResult(NamedTuple):
    idx: torch.Tensor         # (ksel,) selected indices (on the points' device)
    radius: torch.Tensor      # () measured anticover radius
    min_dist: torch.Tensor    # (n,)
    counts: tuple             # trajectory x-axis
    traj: np.ndarray          # (S,) radius trajectory
    schedule: tuple           # executed (block, rounds) phases
    cert: RadiusCertificate


def _result(run: AdaptiveRun, cert, device) -> AdaptiveGMMResult:
    return AdaptiveGMMResult(
        idx=torch.as_tensor(run.idx[0], device=device),
        radius=torch.tensor(float(run.radius[0]), device=device),
        min_dist=run.min_dist, counts=run.counts, traj=run.traj[:, 0],
        schedule=run.schedule, cert=cert)


def gmm_adaptive(points, k: int, *, b0: int = 8, metric="euclidean",
                 mask=None, start=0, chunk: int = 0,
                 use_pallas="auto", gamma: float = 0.0,
                 tau: Optional[float] = None, cliff: Optional[float] = None,
                 scale_count: Optional[int] = None,
                 eps: Optional[float] = None,
                 sprint="auto", device=None) -> AdaptiveGMMResult:
    """Adaptive-b GMM: lookahead-b speed where the radius curve is steep, an
    exact b=1 continuation once it flattens.  Any k works — the schedule is
    discovered, not prescribed."""
    points = as_points(points, device)
    n = points.shape[0]
    labels = mask_to_labels(_as_mask(mask, points))
    run = adaptive_select(points, labels, [start], 1, k, b0=b0, gamma=gamma,
                          tau=tau, cliff=cliff, chunk=chunk, metric=metric,
                          use_pallas=use_pallas,
                          scale_count=scale_count or min(k, n), eps=eps,
                          sprint=sprint)
    cert = certificate_from_trajectory(
        run.counts, run.traj[:, 0], scale_count or min(k, n), eps=eps,
        b_schedule=run.schedule)
    return _result(run, cert, points.device)


def auto_kprime(points, k: int, eps: float = 0.1,
                measure: str = "remote-edge", *, metric="euclidean",
                b="auto", chunk: int = 0, use_pallas="auto",
                kprime_max: Optional[int] = None, mask=None,
                start=0, tau: Optional[float] = None,
                cliff: Optional[float] = None,
                sprint="auto", device=None) -> AdaptiveGMMResult:
    """ε-targeted core-set sizing: grow k' until the measured radius
    certificate meets the target (ratio = 2·r_T(k')/scale_k <= eps),
    resuming the same engine run at every milestone.  ``measure`` is
    recorded for context; the certificate is the remote-edge bound."""
    del measure  # certificate is measure-agnostic (remote-edge bound)
    points = as_points(points, device)
    n = points.shape[0]
    labels = mask_to_labels(_as_mask(mask, points))
    if k < 1 or k > n:
        raise ValueError(f"k={k} out of range for n={n}")
    kmax, miles = auto_milestones(k, n, kprime_max)
    b0 = 8 if b == "auto" else max(1, int(b))
    run = adaptive_select(points, labels, [start], 1, kmax, b0=b0, tau=tau,
                          cliff=cliff, chunk=chunk, metric=metric,
                          use_pallas=use_pallas,
                          milestones=miles, eps=eps, scale_count=k,
                          sprint=sprint)
    cert = certificate_from_trajectory(run.counts, run.traj[:, 0], k,
                                       eps=eps, b_schedule=run.schedule)
    return _result(run, cert, points.device)


# --------------------------------------------------------------------------
# probe -> static plan (for the MapReduce reducers, which share one schedule)
# --------------------------------------------------------------------------

def plan_from_schedule(executed, kprime: int,
                       probe_k: int) -> Tuple[Tuple[int, int], ...]:
    """Convert an executed adaptive schedule into a static two-phase plan
    covering ``kprime`` picks: keep the probe's leading full-size blocks for
    the same *fraction* of the run, finish at b=1.  Exact-GMM tails and
    whole-run lookahead both fall out naturally."""
    if not executed:
        return ((1, kprime),)
    b0 = executed[0][0]
    head_picks = 1  # the seed
    for bsz, rounds in executed:
        if bsz != b0:
            break
        head_picks += bsz * rounds
    if b0 <= 1:
        return ((1, kprime),)
    frac = min(1.0, head_picks / max(probe_k, 1))
    head_rounds = int(frac * kprime) // b0
    head_rounds = max(0, min(head_rounds, kprime // b0))
    tail = kprime - head_rounds * b0
    if head_rounds == 0:
        return ((1, kprime),)
    if tail == 0:
        return ((b0, head_rounds),)
    return ((b0, head_rounds), (1, tail))


def probe_stride(n: int, sample: int = 8192) -> int:
    """Row stride of the probe's subsample ``points[::stride]`` of an
    ``n``-row input (about ``sample`` rows)."""
    return max(1, n // max(1, min(sample, n)))


def resolve_engine_plan(points, k: int, kprime, b, *, eps: float = 0.1,
                        metric="euclidean", labels=None, m: int = 1,
                        chunk: int = 0, use_pallas="auto",
                        sample: int = 8192, tau: Optional[float] = None,
                        cliff: Optional[float] = None, sprint="auto",
                        device=None):
    """Resolve ``b="auto"`` / ``kprime="auto"`` into static engine inputs
    for the MapReduce reducers, which all run one shared schedule: a cheap
    strided-subsample probe runs the adaptive controller once (on the
    card, through the sweep kernels, with ``use_pallas="auto"``), and its
    outcome is frozen into (kprime:int, schedule|None, cert).  ``labels``
    (host ints, one per point) probe the grouped engine over ``m`` groups.

    Numeric knobs pass through untouched (schedule=None means "use ``b`` as
    given")."""
    if b != "auto" and kprime != "auto":
        return kprime, None, None
    points = as_points(points, device)
    stride = probe_stride(points.shape[0], sample)
    lab = (None if labels is None
           else np.asarray(to_numpy(labels))[::stride])
    return probe_engine_plan(points[::stride], lab, k, kprime, b, eps=eps,
                             metric=metric, m=m, chunk=chunk,
                             use_pallas=use_pallas, tau=tau, cliff=cliff,
                             sprint=sprint)


def probe_engine_plan(sub, labels, k: int, kprime, b, *, eps: float = 0.1,
                      metric="euclidean", m: int = 1, chunk: int = 0,
                      use_pallas="auto", tau: Optional[float] = None,
                      cliff: Optional[float] = None, sprint="auto"):
    """The probe of ``resolve_engine_plan`` on its subsample ``sub`` (a
    tensor; ``labels`` its host labels or None), which the MapReduce mesh
    path gathers from the ranks' shards.  Returns (kprime:int,
    schedule|None, cert)."""
    sn = sub.shape[0]
    lab = (np.zeros((sn,), np.int32) if labels is None
           else np.asarray(labels).astype(np.int32))
    mm = 1 if labels is None else m
    counts = np.bincount(lab[lab >= 0], minlength=mm)[:mm]
    starts = np.zeros((mm,), np.int64)
    for g in range(mm):
        hits = np.nonzero(lab == g)[0]
        starts[g] = hits[0] if hits.size else 0
    k_probe = min(k, sn)
    group_counts = counts if labels is not None else None
    if kprime == "auto":
        kmax, miles = auto_milestones(k_probe, sn)
        run = adaptive_select(sub, lab, starts, mm, kmax,
                              b0=8 if b == "auto" else max(1, int(b)),
                              tau=tau, cliff=cliff, chunk=chunk,
                              metric=metric, use_pallas=use_pallas,
                              milestones=miles, eps=eps,
                              scale_count=k_probe,
                              group_counts=group_counts, sprint=sprint)
        kp = run.ksel
    else:
        kp = int(kprime)
        run = adaptive_select(sub, lab, starts, mm, min(kp, sn), b0=8,
                              tau=tau, cliff=cliff, chunk=chunk,
                              metric=metric, use_pallas=use_pallas,
                              scale_count=k_probe,
                              group_counts=group_counts, sprint=sprint)
    cert = certificate_from_trajectory(
        run.counts, run.traj.max(axis=1), k_probe,
        eps=eps if kprime == "auto" else None, b_schedule=run.schedule)
    schedule = (plan_from_schedule(run.schedule, kp, run.ksel)
                if b == "auto" else None)
    if schedule is not None:
        validate_schedule(schedule, kp)
    return kp, schedule, cert
