"""Row recovery for diversity selections (port of the ``_match_rows`` part
of ``repro.data.selection``; the selection entry points wait for later slices).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_numpy


def _match_rows(pts: torch.Tensor, sol, k: int, *,
                chunk: int = 65536) -> np.ndarray:
    """Map solution points back to distinct row indices (exact match by row).

    ``pts`` stays on its device: the (n, k) distances of every row to every
    solution point are computed there in row chunks (exact differences, not
    the factorized form, so an identical row scores exactly 0), then each
    pick is a masked first-argmin over rows not taken yet.  One host read at
    the end.
    """
    dev = pts.device
    sol = torch.as_tensor(sol, dtype=pts.dtype, device=dev).reshape(-1,
                                                                    pts.shape[1])
    n = pts.shape[0]
    dist = torch.empty((n, sol.shape[0]), dtype=pts.dtype, device=dev)
    for s in range(0, n, chunk):
        dist[s:s + chunk] = torch.cdist(
            pts[s:s + chunk], sol,
            compute_mode="donot_use_mm_for_euclid_dist")
    taken = torch.zeros((n,), dtype=torch.bool, device=dev)
    picks, finite = [], []
    for t in range(sol.shape[0]):
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
