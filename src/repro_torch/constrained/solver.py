"""Sequential solvers for matroid-constrained diversity maximization (port
of ``repro.constrained.solver``).

``feasible_greedy``   — GMM-style farthest-point greedy restricted to groups
                        the matroid's ``grow_mask`` allows (always returns a
                        feasible basis).
``local_search``      — oracle-checked exchange descent: a swap (p ∈ S,
                        q ∉ S) is a candidate iff the matroid's ``swap_mask``
                        keeps S − p + q a feasible basis.  For exact
                        partition quotas this reduces to the classic
                        same-group swap; evaluating ALL candidate swaps of
                        one pass costs a handful of batched gathers on the
                        precomputed pairwise matrix, no per-pair python-loop
                        distance work.
``constrained_solve`` — greedy + local-search, the production entry point.
``brute_force_constrained`` — exact optimum by enumeration over feasible
                        count vectors × per-group combinations; test scale
                        only.

Every entry point accepts ``quotas=`` (sugar for an exact-quota
``PartitionMatroid``) or ``matroid=`` (any ``constrained.matroid``
oracle — partition ranges, transversal, laminar, or your own label-count
matroid).

These run on core-set-scale candidate sets (hundreds–low thousands), so the
numpy idiom of ``core.sequential`` applies: one ``(n, n)`` distance matrix,
computed where the candidate points live (on the card for a tensor there)
and copied to the host once, then O(k·n) vectorized scans per iteration on
the host, no device round-trips.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.measures import diversity
from ..core.sequential import _pairwise_np

from .matroid import Matroid, as_matroid


def _rows(points, idx):
    """``points[idx]`` for a tensor (on its device) or an array."""
    if isinstance(points, torch.Tensor):
        return points[torch.as_tensor(idx, device=points.device)]
    return np.asarray(points)[idx]


def feasible_greedy(dm: np.ndarray, labels: np.ndarray, quotas=None, *,
                    matroid: Optional[Matroid] = None,
                    start: Optional[int] = None) -> np.ndarray:
    """Farthest-point greedy under a matroid constraint.

    At every step the next pick is the point with the largest distance to the
    current selection among points whose group the matroid's ``grow_mask``
    still admits — exactly GMM with a feasibility mask, so each step is one
    vectorized scan of the running min-distance field.  With exact partition
    quotas the mask is ``counts < quotas``, reproducing the original quota
    greedy bit-for-bit.
    """
    mat = as_matroid(matroid, quotas)
    n = dm.shape[0]
    labels = np.asarray(labels)
    counts = np.zeros(mat.m, np.int64)
    k = mat.k
    if k == 0:
        return np.zeros((0,), np.int64)
    allowed = mat.grow_mask(counts)[labels]
    if start is None:
        # deterministic spread-out seed: the point with the largest total
        # distance mass among allowed points
        start = int(np.where(allowed, dm.sum(axis=1), -np.inf).argmax())
    sel = [start]
    counts[labels[start]] += 1
    taken = np.zeros(n, bool)
    taken[start] = True
    min_dist = dm[start].astype(np.float64).copy()
    for _ in range(k - 1):
        feas = mat.grow_mask(counts)[labels] & ~taken
        cand = np.where(feas, min_dist, -np.inf)
        j = int(cand.argmax())
        if not np.isfinite(cand[j]):
            raise ValueError("quotas infeasible for the candidate set")
        sel.append(j)
        taken[j] = True
        counts[labels[j]] += 1
        min_dist = np.minimum(min_dist, dm[j])
    return np.asarray(sel, np.int64)


# Measures whose objective the swap descent genuinely improves: the clique
# delta is exact, and remote-edge IS the bottleneck min-distance.  For the
# other measures the bottleneck is only a surrogate (a swap that raises it can
# lower e.g. the true star value), so constrained_solve stops at the greedy
# basis for them — mirroring the unconstrained solvers, where the GMM prefix
# (the same bottleneck greedy) is the proven α-approximation.
LOCAL_SEARCH_MEASURES = ("remote-edge", "remote-clique")


def _offdiag_min(sub: np.ndarray) -> float:
    if sub.shape[0] < 2:
        return np.inf
    off = sub + np.where(np.eye(sub.shape[0], dtype=bool), np.inf, 0.0)
    return float(off.min())


def local_search(dm: np.ndarray, labels: np.ndarray, sel: np.ndarray,
                 measure: str, *, matroid: Optional[Matroid] = None,
                 max_rounds: int = 10, tol: float = 1e-9) -> np.ndarray:
    """Oracle-checked exchange descent.  A swap (p ∈ S, q ∉ S) is feasible
    iff the matroid admits S − p + q as a complete solution — the matroid's
    ``swap_mask`` answers that for all n candidates at once, so the search
    space is exactly the feasible exchange neighborhood.  ``matroid=None``
    keeps the legacy rule (same-group swaps — the exact-partition-quota
    neighborhood).

    Per round, for every selected p the improvement of ALL its candidate
    replacements is evaluated at once from the precomputed ``dm``:

    * remote-clique: Δ(p→q) = Σ_{s∈S∖p} d(q,s) − Σ_{s∈S∖p} d(p,s) — one
      matrix-row reduction per p;
    * remote-edge: the new bottleneck min(d(q, S∖p), offdiag-min(S∖p)) —
      one masked row-min per p.

    Only the ``LOCAL_SEARCH_MEASURES`` objectives are exact under these
    deltas; ``constrained_solve`` skips the descent for other measures.

    First-improvement per p, best-improvement across candidates.
    """
    n = dm.shape[0]
    labels = np.asarray(labels)
    sel = np.asarray(sel, np.int64).copy()
    k = sel.shape[0]
    if k < 2:
        return sel  # a singleton has no swap that changes any pair distance
    in_sel = np.zeros(n, bool)
    in_sel[sel] = True
    clique = measure == "remote-clique"
    counts = None
    if matroid is not None:
        counts = np.bincount(labels[sel], minlength=matroid.m)

    for _ in range(max_rounds):
        improved = False
        for pos in range(k):
            p = sel[pos]
            rest = np.delete(sel, pos)
            if matroid is None:
                cand_ok = labels == labels[p]
            else:
                cand_ok = matroid.swap_mask(counts, int(labels[p]))[labels]
            cand = np.where(cand_ok & ~in_sel)[0]
            if cand.size == 0:
                continue
            d_cand = dm[np.ix_(cand, rest)]              # (c, k-1) batched
            if clique:
                cur = dm[p, rest].sum()
                gain = d_cand.sum(axis=1) - cur
                b = int(gain.argmax())
                if gain[b] > tol:
                    in_sel[p] = False
                    in_sel[cand[b]] = True
                    sel[pos] = cand[b]
                    improved = True
            else:
                base = _offdiag_min(dm[np.ix_(rest, rest)])
                cur = min(base, float(dm[p, rest].min()) if k > 1 else np.inf)
                new = np.minimum(d_cand.min(axis=1), base)
                b = int(new.argmax())
                if new[b] > cur + tol:
                    in_sel[p] = False
                    in_sel[cand[b]] = True
                    sel[pos] = cand[b]
                    improved = True
            if sel[pos] != p and counts is not None:
                counts[labels[p]] -= 1
                counts[labels[sel[pos]]] += 1
        if not improved:
            break
    return sel


def constrained_solve(points, labels, quotas=None,
                      measure: str = "remote-edge", *,
                      matroid: Optional[Matroid] = None,
                      metric="euclidean", swap_rounds: int = 10,
                      exact_limit: int = 5000,
                      dm: Optional[np.ndarray] = None) -> np.ndarray:
    """Feasible greedy + oracle-checked local search.  Returns row indices
    into ``points`` forming a feasible basis of the matroid (``k`` = the
    matroid's target size; for exact quotas, exactly ``quotas[g]`` picks per
    group).

    When the enumeration space (Σ over feasible count vectors of
    ``prod_g C(n_g, c_g)``) is at most ``exact_limit`` the exact brute-force
    solver runs instead (small instances deserve the true optimum; pass
    ``exact_limit=0`` to force the greedy + local-search path).

    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> pts = rng.normal(size=(40, 2)).astype(np.float32)
    >>> lab = rng.integers(0, 2, size=40)
    >>> idx = constrained_solve(pts, lab, [2, 2], exact_limit=0)
    >>> np.bincount(lab[idx], minlength=2).tolist()
    [2, 2]
    """
    mat = as_matroid(matroid, quotas)
    labels = np.asarray(labels)
    mat.validate_ground_set(labels)
    if exact_limit and mat.search_space_size(labels,
                                             cap=exact_limit) <= exact_limit:
        _, idx = brute_force_constrained(points, labels, measure=measure,
                                         matroid=mat, metric=metric)
        return idx
    if dm is None:
        dm = _pairwise_np(points, metric)
    sel = feasible_greedy(dm, labels, matroid=mat)
    if swap_rounds > 0 and measure in LOCAL_SEARCH_MEASURES:
        sel = local_search(dm, labels, sel, measure, matroid=mat,
                           max_rounds=swap_rounds)
    return sel


def solve_and_value(points, labels, quotas=None,
                    measure: str = "remote-edge", *,
                    matroid: Optional[Matroid] = None, metric="euclidean",
                    swap_rounds: int = 10,
                    exact_limit: int = 5000) -> Tuple[np.ndarray, float]:
    """``constrained_solve`` + objective evaluation of the selected subset —
    the shared tail of every constrained driver.  Returns (indices, value)."""
    sel = constrained_solve(points, labels, quotas, measure, matroid=matroid,
                            metric=metric, swap_rounds=swap_rounds,
                            exact_limit=exact_limit)
    return sel, diversity(measure, _pairwise_np(_rows(points, sel), metric))


def brute_force_constrained(points, labels, quotas=None,
                            measure: str = "remote-edge", *,
                            matroid: Optional[Matroid] = None,
                            metric="euclidean") -> Tuple[float, np.ndarray]:
    """Exact constrained optimum by enumeration: every feasible count vector
    of the matroid × every per-group combination realizing it.

    Returns (value, indices).  Cost is ``Σ_c prod_g C(n_g, c_g)`` subset
    evaluations — test scale only.  For exact quotas there is a single count
    vector and this is the original per-group enumeration.
    """
    mat = as_matroid(matroid, quotas)
    labels = np.asarray(labels)
    mat.validate_ground_set(labels)
    m = mat.m
    dm = _pairwise_np(points, metric)
    group_members = [np.where(labels == g)[0] for g in range(m)]
    avail = np.asarray([gm.shape[0] for gm in group_members], np.int64)
    best_val, best_idx = -np.inf, None
    for cvec in mat.basis_count_vectors(avail):
        per_group = [itertools.combinations(gm.tolist(), int(q))
                     for gm, q in zip(group_members, cvec)]
        for combo in itertools.product(*per_group):
            idx = np.asarray([i for part in combo for i in part], np.int64)
            val = diversity(measure, dm[np.ix_(idx, idx)])
            if val > best_val:
                best_val, best_idx = val, idx
    if best_idx is None:
        raise ValueError("empty search space (all quotas zero?)")
    return float(best_val), best_idx
