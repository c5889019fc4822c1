"""Fused GMM round on the card: running min plus the masked global
(max, argmax).

Port of ``repro.kernels.gmm_update.gmm_update_select_pallas``.  It is the
p = 1 instance of the sweep in ``csrc/gmm_sweep.cu``: each tile reduces its
masked field to one (max, first argmax) pair, and the cross-tile argmax
stays here, as it did in the reference.  The plain version is
``ref.gmm_update_select_ref``.

The grouped sweep of the reference's constrained subsystem
(``gmm_grouped_topb_pallas``) is not ported yet (ROADMAP, constrained
slice).
"""
from __future__ import annotations

import torch

from . import build
from .gmm_topb import launch_sweep, tile_rows
from .ref import gmm_update_select_ref, take  # noqa: F401  (plain version)


def gmm_update_select_cuda(points, centers, xsq, min_in, mask, *, mode: str,
                           bn: int = None):
    """Fused round on the card.  points (n, d), centers (b, d), xsq (n,)
    (euclidean modes; None otherwise), min_in (n,), mask (n,) ->
    (min_out (n,), argmax () int64, max ())."""
    bn = tile_rows(1) if bn is None else bn
    min_out, tv, ti = launch_sweep(points, centers, xsq, min_in, mask,
                                   mode=mode, p=1, bn=bn)
    build.LAUNCHES["gmm_update_select"] += 1
    g = torch.argmax(tv)
    return min_out, take(ti, g).long(), take(tv, g)
