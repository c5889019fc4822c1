"""The six diversity objectives of the paper (Table 1), multiplicity-aware
(port of ``repro.core.measures``: the same numpy bodies, with the distance
matrices of the two helpers built by the port's torch metrics).

All functions take a distance matrix ``dm`` of shape ``(k, k)`` over the chosen
subset (build it with ``metrics.get_metric(m).pairwise(sub, sub)``) and return
a scalar.  Multiplicities: a ``weights`` vector (integers >= 1) marks points
that stand for ``w`` co-located replicas (distance 0 between replicas) — this is
exactly the "generalized diversity" of §6 of the paper.  ``weights=None`` means
all-ones.

remote-bipartition and remote-cycle are NP-hard even to *evaluate*;  we provide
exact evaluators for small ``k`` (enumeration / Held–Karp) and documented
heuristic evaluators otherwise — the paper's own experiments only score
remote-edge, so exact small-k evaluation is what the test-suite uses.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

MEASURES = (
    "remote-edge",
    "remote-clique",
    "remote-star",
    "remote-bipartition",
    "remote-tree",
    "remote-cycle",
)

# Measures whose core-sets need the injective proxy function (Lemma 2);
# these use GMM-EXT / SMM-EXT / GMM-GEN constructions.
NEEDS_INJECTIVE = (
    "remote-clique",
    "remote-star",
    "remote-bipartition",
    "remote-tree",
)


def _expand(dm, weights):
    """Expand a weighted distance matrix into the full multiset matrix."""
    if weights is None:
        return np.asarray(dm)
    dm = np.asarray(dm)
    w = np.asarray(weights).astype(int)
    idx = np.repeat(np.arange(dm.shape[0]), w)
    out = dm[np.ix_(idx, idx)]
    # replicas of the same point are at distance 0 — dm diag is already 0 and
    # dm[i, i] entries cover replica pairs, so the gather above is correct.
    return out


def remote_edge(dm, weights=None):
    dm = _expand(dm, weights)
    k = dm.shape[0]
    if k < 2:
        return 0.0
    off = np.where(np.eye(k, dtype=bool), np.inf, dm)
    return float(off.min())


def remote_clique(dm, weights=None):
    dm = _expand(dm, weights)
    return float(dm.sum() / 2.0)  # unordered pairs


def remote_star(dm, weights=None):
    dm = _expand(dm, weights)
    return float(dm.sum(axis=1).min())


def remote_tree(dm, weights=None):
    """MST weight via Prim's algorithm, O(k^2)."""
    dm = _expand(dm, weights)
    k = dm.shape[0]
    if k < 2:
        return 0.0
    in_tree = np.zeros(k, bool)
    in_tree[0] = True
    best = dm[0].copy()
    total = 0.0
    for _ in range(k - 1):
        best_masked = np.where(in_tree, np.inf, best)
        j = int(best_masked.argmin())
        total += best_masked[j]
        in_tree[j] = True
        best = np.minimum(best, dm[j])
    return float(total)


def remote_bipartition(dm, weights=None, exact_limit=16):
    """min over |Q| = floor(k/2) of the Q vs S\\Q cut weight.

    Exact enumeration for k <= exact_limit, otherwise a Kernighan–Lin style
    local-search heuristic (documented approximation; upper bound on the true
    minimum).
    """
    dm = _expand(dm, weights)
    k = dm.shape[0]
    if k < 2:
        return 0.0
    h = k // 2
    idx = np.arange(k)
    if k <= exact_limit:
        best = np.inf
        for Q in itertools.combinations(range(k), h):
            q = np.asarray(Q)
            z = np.setdiff1d(idx, q)
            best = min(best, dm[np.ix_(q, z)].sum())
        return float(best)
    # heuristic: random restarts + single-swap descent
    rng = np.random.default_rng(0)
    best = np.inf
    for _ in range(8):
        perm = rng.permutation(k)
        q = set(perm[:h].tolist())
        improved = True
        while improved:
            improved = False
            ql = sorted(q)
            zl = sorted(set(range(k)) - q)
            cur = dm[np.ix_(ql, zl)].sum()
            for a in ql:
                for b in zl:
                    q2 = (q - {a}) | {b}
                    q2l = sorted(q2)
                    z2l = sorted(set(range(k)) - q2)
                    val = dm[np.ix_(q2l, z2l)].sum()
                    if val < cur - 1e-12:
                        q, cur, improved = q2, val, True
                        break
                if improved:
                    break
        best = min(best, cur)
    return float(best)


def remote_cycle(dm, weights=None, exact_limit=12):
    """w(TSP) — exact Held–Karp for k <= exact_limit, else NN + 2-opt."""
    dm = _expand(dm, weights)
    k = dm.shape[0]
    if k < 2:
        return 0.0
    if k == 2:
        return float(2 * dm[0, 1])
    if k <= exact_limit:
        # Held–Karp over subsets containing node 0
        full = 1 << (k - 1)
        INF = np.inf
        dp = np.full((full, k - 1), INF)
        for j in range(k - 1):
            dp[1 << j, j] = dm[0, j + 1]
        for mask in range(full):
            for j in range(k - 1):
                if not (mask >> j) & 1 or dp[mask, j] == INF:
                    continue
                base = dp[mask, j]
                for l in range(k - 1):
                    if (mask >> l) & 1:
                        continue
                    nm = mask | (1 << l)
                    cand = base + dm[j + 1, l + 1]
                    if cand < dp[nm, l]:
                        dp[nm, l] = cand
        best = min(dp[full - 1, j] + dm[j + 1, 0] for j in range(k - 1))
        return float(best)
    # heuristic for large k: nearest neighbour + 2-opt
    order = [0]
    left = set(range(1, k))
    while left:
        cur = order[-1]
        nxt = min(left, key=lambda j: dm[cur, j])
        order.append(nxt)
        left.remove(nxt)
    order = np.asarray(order)

    def tour_len(o):
        return float(dm[o, np.roll(o, -1)].sum())

    improved = True
    while improved:
        improved = False
        for i in range(1, k - 1):
            for j in range(i + 1, k):
                new = np.concatenate([order[:i], order[i : j + 1][::-1], order[j + 1 :]])
                if tour_len(new) < tour_len(order) - 1e-12:
                    order = new
                    improved = True
    return tour_len(order)


_FUNCS = {
    "remote-edge": remote_edge,
    "remote-clique": remote_clique,
    "remote-star": remote_star,
    "remote-bipartition": remote_bipartition,
    "remote-tree": remote_tree,
    "remote-cycle": remote_cycle,
}


def diversity(measure: str, dm, weights=None) -> float:
    """Evaluate a diversity measure on a subset's distance matrix."""
    return _FUNCS[measure](dm, weights)


def solution_value(sol, measure: str, metric: str) -> float:
    """The objective of a (k, d) solution, its (k, k) distance matrix
    computed where the solution lives."""
    from .metrics import get_metric

    sol = torch.as_tensor(sol, dtype=torch.float32)
    dm = get_metric(metric).pairwise(sol, sol)
    return diversity(measure, dm.detach().cpu().numpy())


def diversity_of_subset(measure: str, points, idx, metric, weights=None) -> float:
    from .metrics import get_metric

    sub = torch.as_tensor(np.asarray(points)[np.asarray(idx)],
                          dtype=torch.float32)
    dm = get_metric(metric).pairwise(sub, sub).numpy()
    return diversity(measure, dm, weights)


def brute_force_opt(measure: str, points, k: int, metric) -> float:
    """Exact div_k(S) by enumeration — test-scale only (C(n,k) small)."""
    from .metrics import get_metric

    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32)
    n = pts.shape[0]
    dm_full = get_metric(metric).pairwise(pts, pts).numpy()
    best = -np.inf
    for comb in itertools.combinations(range(n), k):
        c = np.asarray(comb)
        val = diversity(measure, dm_full[np.ix_(c, c)])
        best = max(best, val)
    return float(best)
