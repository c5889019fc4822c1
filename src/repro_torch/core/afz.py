"""AFZ — the state-of-the-art competitor of paper §7.3 (Table 4) (port of
``repro.core.afz``).

Aghamolaei, Farhadi, Zarrabi-Zadeh, "Diversity Maximization via Composable
Coresets" (CCCG 2015).  For remote-clique their composable core-set is
built by **local search**: start from an arbitrary k'-subset and keep
swapping a chosen point with an outside point while the remote-clique
value of the subset improves.  Each sweep is O(k'·n) candidate
evaluations, which is why Table 4 shows CPPU beating it by orders of
magnitude.

The shard's (n, n) distance matrix is the B3 distance kernel on the card
(``kernels.ops.pairwise``; its plain version on the CPU or with
``use_pallas=False``), copied to the host once; the local search is numpy,
as in the reference.  For remote-edge AFZ degenerates to GMM with k'=k
(paper §7.3), so only the remote-clique construction is implemented.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_points, resolve_use_pallas, to_numpy
from ..kernels import ops as kops
from .metrics import get_metric


def _distance_matrix(pts, metric, use_pallas) -> np.ndarray:
    met = get_metric(metric)
    if met.name not in ("euclidean", "sqeuclidean", "cosine"):
        return to_numpy(met.pairwise(pts, pts))
    if resolve_use_pallas(use_pallas, pts.device, met.name):
        return to_numpy(kops.pairwise(pts, pts, met.name))
    p = kops.prepare(pts, met.name)
    return to_numpy(kops.ref.pairwise_ref(p.points, p.points, met.name,
                                          xsq=p.xsq, ysq=p.xsq))


def afz_coreset_clique(points, kprime: int, *, metric="euclidean",
                       max_sweeps: int = 50, eps: float = 1e-7,
                       seed: int = 0, use_pallas="auto",
                       device=None) -> torch.Tensor:
    """Local-search max-sum k'-subset of ``points``.  Returns the (k', d)
    rows on the points' device."""
    pts = as_points(points, device)
    n = pts.shape[0]
    if kprime >= n:
        return pts
    dm = _distance_matrix(pts, metric, use_pallas)
    rng = np.random.default_rng(seed)
    sel = rng.choice(n, size=kprime, replace=False)
    in_sel = np.zeros(n, bool)
    in_sel[sel] = True
    for _ in range(max_sweeps):
        improved = False
        # dist of every point to the current selection (sum)
        sum_to_sel = dm[:, sel].sum(axis=1)
        for si in range(kprime):
            i = sel[si]
            # removing i: every candidate j gains sum_to_sel[j] - dm[j, i]
            gain_j = sum_to_sel - dm[:, i]
            gain_j[in_sel] = -np.inf
            j = int(gain_j.argmax())
            old_i = sum_to_sel[i] - 0.0  # i's own contribution
            if gain_j[j] > old_i * (1 + eps) + eps:
                in_sel[i] = False
                in_sel[j] = True
                sel[si] = j
                sum_to_sel = sum_to_sel - dm[:, i] + dm[:, j]
                improved = True
        if not improved:
            break
    return pts.index_select(0, torch.as_tensor(sel, device=pts.device))


def afz_mr_clique(points, k: int, kprime: int, *, num_reducers: int,
                  metric="euclidean", seed: int = 0, use_pallas="auto",
                  device=None):
    """AFZ in the same 2-round MR harness as CPPU (for Table 4): contiguous
    shards of the first ``per·ℓ`` rows, one local search each, the
    sequential remote-clique solver on the union.  Returns (solution (k, d)
    on the points' device, value)."""
    from .measures import diversity
    from .sequential import solve

    pts = as_points(points, device)
    n, d = pts.shape
    per = n // num_reducers
    shards = pts[: per * num_reducers].view(num_reducers, per, d)
    pieces = [afz_coreset_clique(s, kprime, metric=metric, seed=seed + i,
                                 use_pallas=use_pallas)
              for i, s in enumerate(shards)]
    union = torch.cat(pieces)
    idx = solve("remote-clique", union, k, metric=metric)
    sol = union[torch.as_tensor(idx, device=union.device)]
    return sol, diversity("remote-clique",
                          to_numpy(get_metric(metric).pairwise(sol, sol)))
