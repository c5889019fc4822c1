"""Row recovery and default quotas for diversity selections (port of the
``_match_rows`` and ``balanced_quotas`` parts of ``repro.data.selection``;
the legacy ``select_diverse`` entry point waits for the legacy wrappers).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import to_numpy


def balanced_quotas(group_labels, k: int, m: Optional[int] = None
                    ) -> np.ndarray:
    """Default quotas for labels without a matroid: as close to k/m per
    group as the group sizes allow, the remainder going to the largest
    groups first."""
    labels = np.asarray(to_numpy(group_labels))
    if m is None:
        m = int(labels.max()) + 1 if labels.size else 0
    counts = np.bincount(labels, minlength=m)[:m]
    if counts.sum() < k:
        raise ValueError(f"k={k} exceeds the {counts.sum()} labelled points")
    quotas = np.minimum(counts, k // max(m, 1))
    # distribute the remainder one pick at a time, round-robin over groups
    # with spare capacity, largest group first — keeps the split balanced
    order = np.argsort(-counts)
    while quotas.sum() < k:
        for g in order:
            if quotas.sum() >= k:
                break
            if quotas[g] < counts[g]:
                quotas[g] += 1
    return quotas.astype(np.int64)


def _match_rows(pts: torch.Tensor, sol, k: int, *, row_labels=None,
                sol_labels=None, chunk: int = 65536) -> np.ndarray:
    """Map solution points back to distinct row indices (exact match by row).

    ``pts`` stays on its device: the (n, k) distances of every row to every
    solution point are computed there in row chunks (exact differences, not
    the factorized form, so an identical row scores exactly 0), then each
    pick is a masked first-argmin over rows not taken yet.  With
    ``row_labels``/``sol_labels`` a solution point only matches rows of its
    own group (a constrained solution keeps its quotas).  One host read at
    the end.
    """
    dist = _row_distances(pts, sol, row_labels=row_labels,
                          sol_labels=sol_labels, chunk=chunk)
    n, dev = pts.shape[0], pts.device
    taken = torch.zeros((n,), dtype=torch.bool, device=dev)
    picks, finite = [], []
    for t in range(dist.shape[1]):
        d = torch.where(taken, torch.full_like(dist[:, t], float("inf")),
                        dist[:, t])
        j = torch.argmin(d).reshape(1)
        ok = torch.isfinite(d.index_select(0, j))
        taken.index_put_((j,), ok)
        picks.append(j)
        finite.append(ok)
    picks = to_numpy(torch.cat(picks))
    finite = to_numpy(torch.cat(finite))
    return picks[finite][:k]


def _row_distances(pts: torch.Tensor, sol, *, row_labels=None,
                   sol_labels=None, chunk: int = 65536) -> torch.Tensor:
    """The (n, s) exact distances of every row of ``pts`` to every solution
    point, on the rows' device, in row chunks; with labels, a row of
    another group than the solution point's is at +inf.  A row's entries
    depend on that row alone."""
    dev = pts.device
    sol = torch.as_tensor(sol, dtype=pts.dtype, device=dev).reshape(-1,
                                                                    pts.shape[1])
    n = pts.shape[0]
    dist = torch.empty((n, sol.shape[0]), dtype=pts.dtype, device=dev)
    for s in range(0, n, chunk):
        dist[s:s + chunk] = torch.cdist(
            pts[s:s + chunk], sol,
            compute_mode="donot_use_mm_for_euclid_dist")
    if row_labels is not None:
        rl = torch.as_tensor(np.asarray(to_numpy(row_labels)), device=dev)
        sl = torch.as_tensor(np.asarray(to_numpy(sol_labels)), device=dev)
        dist = torch.where(rl[:, None] == sl[None, :], dist,
                           torch.full_like(dist, float("inf")))
    return dist
