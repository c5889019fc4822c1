"""Final-stage sequential α-approximation solvers (paper Table 1 / Fact 2)
and the δ-instantiation of Lemma 7 (port of ``repro.core.sequential``).

Per Fact 2 the best sequential algorithms are "essentially based on either
finding a maximal matching or running GMM on the input set":

* remote-clique              -> greedy farthest-pair matching (Hassin et al., α=2)
* remote-edge                -> GMM prefix (Tamir, α=2)
* remote-star / bipartition  -> GMM prefix (Chandra–Halldórsson, α=2 / 3)
* remote-tree / cycle        -> GMM prefix (Halldórsson et al., α=4 / 3)

All solvers are multiplicity-aware (generalized core-sets, §6): a point with
multiplicity ``m`` may be selected up to ``m`` times; replicas are at distance
0.  These run on core-sets (hundreds–thousands of points), so plain O(k·m) /
O(m²) numpy is the right tool — no device round-trips in the inner loop.
The core-set-sized distance matrix is computed on the points' device and
copied to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_use_pallas, to_numpy
from ..kernels import ops as kops
from .coreset import GeneralizedCoreset
from .metrics import get_metric

SEQ_ALPHA = {
    "remote-edge": 2.0,
    "remote-clique": 2.0,
    "remote-star": 2.0,
    "remote-bipartition": 3.0,
    "remote-tree": 4.0,
    "remote-cycle": 3.0,
}


def _pairwise_np(points, metric) -> np.ndarray:
    """The (m, m) distance matrix, computed where ``points`` live, on the
    host."""
    p = torch.as_tensor(points, dtype=torch.float32)
    return to_numpy(get_metric(metric).pairwise(p, p))


def gmm_multiset(dm: np.ndarray, caps: np.ndarray, k: int) -> np.ndarray:
    """GMM greedy on a weighted point set.  Returns k indices (repeats allowed
    only once all distinct capacity is exhausted — a replica is at distance 0
    from its twin so the greedy max never prefers one while distinct points
    remain)."""
    m = dm.shape[0]
    caps = caps.copy()
    first = int(np.argmax(caps > 0))
    sel = [first]
    caps[first] -= 1
    min_d = dm[first].copy()
    # a point with remaining capacity and min_d == 0 is a replica candidate
    for _ in range(k - 1):
        cand = np.where(caps > 0, min_d, -np.inf)
        j = int(cand.argmax())
        if not np.isfinite(cand[j]):
            break
        sel.append(j)
        caps[j] -= 1
        min_d = np.minimum(min_d, dm[j])
        min_d[j] = 0.0
    return np.asarray(sel, np.int64)


def matching_multiset(dm: np.ndarray, caps: np.ndarray, k: int) -> np.ndarray:
    """Greedy farthest-pair matching (remote-clique α=2), multiplicity-aware.

    In-place masking: exhausted rows/cols are set to -inf once instead of
    rebuilding an (m, m) mask per pick — O(k·m² ) scans, no O(m²) temps."""
    m = dm.shape[0]
    caps = caps.copy()
    sel: list[int] = []
    work = dm.astype(np.float32).copy()
    np.fill_diagonal(work, -np.inf)  # self-pair only via capacity >= 2 (dist 0)
    dead = caps <= 0
    work[dead, :] = -np.inf
    work[:, dead] = -np.inf
    for _ in range(k // 2):
        flat = int(work.argmax())
        i, j = divmod(flat, m)
        if not np.isfinite(work[i, j]):
            # fewer than two distinct points left: spend remaining capacity
            rest = np.repeat(np.arange(m), caps.astype(int))
            need = k - len(sel)
            sel.extend(rest[:need].tolist())
            caps[:] = 0
            break
        sel.extend([i, j])
        for t in (i, j):
            caps[t] -= 1
            if caps[t] <= 0:
                work[t, :] = -np.inf
                work[:, t] = -np.inf
    if len(sel) < k:
        avail = np.where(caps > 0)[0]
        for j in np.repeat(avail, caps[avail].astype(int)):
            if len(sel) >= k:
                break
            sel.append(int(j))
    return np.asarray(sel[:k], np.int64)


def solve(measure: str, points, k: int, *, weights=None,
          metric="euclidean") -> np.ndarray:
    """Run the α-approx sequential solver; returns k row-indices (repeats iff
    multiplicities allow).  ``points`` is a tensor (any device) or array."""
    pts = points
    m = pts.shape[0]
    caps = (np.ones(m, np.int64) if weights is None
            else np.asarray(weights, np.int64).copy())
    if caps.sum() < k:
        raise ValueError(f"expanded size {caps.sum()} < k={k}")
    dm = _pairwise_np(pts, metric)
    if measure == "remote-clique":
        return matching_multiset(dm, caps, k)
    return gmm_multiset(dm, caps, k)


def solve_on_coreset(cs, k: int, measure: str, *,
                     metric="euclidean") -> torch.Tensor:
    """Solve on a Coreset / GeneralizedCoreset; returns the (k, d) points
    (on the core-set's device)."""
    if isinstance(cs, GeneralizedCoreset):
        pts, mult = cs.compact()
        idx = solve(measure, pts, k, weights=mult, metric=metric)
    else:
        pts = cs.compact()
        idx = solve(measure, pts, k, metric=metric)
    return pts[torch.as_tensor(idx, device=pts.device)]


def instantiate(generalized_solution_pts, generalized_solution_counts,
                pool, radius: float, *, metric="euclidean",
                use_pallas="auto") -> torch.Tensor:
    """δ-instantiation (Lemma 7): replace each replica of a kernel point with
    a distinct pool point at distance <= radius.  ``pool`` is the input the
    kernel was drawn from (the MapReduce run's partitioned array).  Falls
    back to the kernel point itself when the pool can't supply enough
    distinct delegates (never happens when pool ⊇ original shard, by
    construction of the multiplicities).

    Each kernel point's distances to the pool are one column of the B3
    distance kernel (``kernels.ops.pairwise`` with one center; its plain
    version on the CPU or with ``use_pallas=False``), on the pool's
    device; one host read per kernel point finds its delegates.  Returns the
    (sum of counts, d) points on the pool's device."""
    pool = torch.as_tensor(pool, dtype=torch.float32)
    used = torch.zeros((pool.shape[0],), dtype=torch.bool, device=pool.device)
    out = []
    for (p, hits), cnt in zip(
            _within_radius(pool, generalized_solution_pts, radius,
                           metric=metric, use_pallas=use_pallas),
            np.asarray(generalized_solution_counts)):
        take = torch.nonzero(hits & ~used).flatten()[:int(cnt)]
        used[take] = True
        out.append(pool.index_select(0, take))
        out.extend([p[None]] * (int(cnt) - int(take.shape[0])))
    return torch.cat(out) if out else pool[:0]


def _within_radius(pool, kernel_pts, radius: float, *, metric="euclidean",
                   use_pallas="auto"):
    """For each kernel point in turn, (the point, the boolean mask of the
    ``pool`` rows within ``radius``·(1 + 1e-6) of it): one column of the B3
    distance kernel a kernel point (its plain version on the CPU or with
    ``use_pallas=False``), on the pool's device.  A row's entry depends on
    that row alone, so a shard of the pool sees the entries the whole pool
    does."""
    pool = torch.as_tensor(pool, dtype=torch.float32)
    dev = pool.device
    pts = torch.as_tensor(kernel_pts, dtype=torch.float32, device=dev)
    met = get_metric(metric)
    kernel_metric = met.name in ("euclidean", "sqeuclidean", "cosine")
    use_pallas = resolve_use_pallas(use_pallas, dev, met.name)
    prep = kops.prepare(pool, met.name) if kernel_metric else None
    thr = torch.tensor(radius * (1 + 1e-6), dtype=torch.float32, device=dev)
    for p in pts:
        if not kernel_metric:
            d = met.point_to_set(pool, p)
        else:
            c = kops.prepare(p[None], met.name)
            args = (prep.points, c.points, met.name)
            kw = dict(xsq=prep.xsq, ysq=c.xsq)
            d = (kops.pairwise(*args, **kw, prepared=True) if use_pallas
                 else kops.ref.pairwise_ref(*args, **kw))[:, 0]
        yield p, d <= thr
