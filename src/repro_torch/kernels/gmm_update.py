"""Fused GMM rounds on the card: the masked global (max, argmax) of the
unconstrained engine and the grouped sweep of the constrained one.

``gmm_update_select_cuda`` ports
``repro.kernels.gmm_update.gmm_update_select_pallas``.  It is the p = 1
instance of the sweep in ``csrc/gmm_sweep.cu``: each tile reduces its
masked field to one (max, first argmax) pair, and the cross-tile argmax
stays here, as it did in the reference.  The plain version is
``ref.gmm_update_select_ref``.

``gmm_grouped_topb_cuda`` ports ``gmm_grouped_topb_pallas``; the CUDA body
is ``csrc/gmm_grouped.cu`` (see the note there on its bound and design).
Each row folds only its own group's center block, each tile keeps every
group's top-p, and the per-group merge of the tile winners stays here, as
does the conversion of the centers to the kernel's float64 scratch.  The
plain version is ``ref.gmm_grouped_topb_ref``.
"""
from __future__ import annotations

import torch

from . import build
from .gmm_topb import MODES, TILE_ROWS, launch_sweep, tile_rows
from .ref import (gmm_grouped_topb_ref, gmm_update_select_ref,  # noqa: F401
                  merge_tiles_grouped, take)

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


def grouped_tile_rows(p: int) -> int:
    """Rows per tile of the grouped sweep: ``tile_rows(p)``, at least 1024
    (a tile's center staging and sort serve more rows)."""
    return max(1024, tile_rows(p))


def _check_grouped(points, centers, xsq, min_in, labels, mode, p, bn):
    n, d = points.shape
    if centers.ndim != 3 or centers.shape[2] != d:
        raise ValueError(f"centers {tuple(centers.shape)} must be (m, bc, "
                         f"{d})")
    named = {"points": points, "centers": centers, "min_in": min_in}
    if mode in ("sqeuclidean", "euclidean"):
        if xsq is None:
            raise ValueError(f"mode {mode!r} needs the squared norms xsq")
        named["xsq"] = xsq
    for name, t in named.items():
        if not t.is_cuda or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != points.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{points.device}")
    if min_in.shape != (n,) or (xsq is not None and xsq.shape != (n,)):
        raise ValueError("min_in and xsq must have shape (n,)")
    if labels.shape != (n,) or labels.dtype != torch.int32 \
            or labels.device != points.device or not labels.is_contiguous():
        raise ValueError("labels must be a contiguous (n,) int32 tensor on "
                         f"{points.device}")
    if mode not in MODES:
        raise ValueError(f"no kernel mode {mode!r}")
    if bn not in TILE_ROWS or bn < 1024 or bn < p:
        raise ValueError(f"tile rows bn={bn} must be one of {TILE_ROWS[2:]} "
                         f"and >= p={p}")
    m = centers.shape[0]
    if n >= 2 ** 31 - bn or m * (-(-n // bn)) * p >= 2 ** 31:
        raise ValueError(f"n={n}, m={m}, p={p} exceed the kernel's int32 "
                         "sizes")


def gmm_grouped_topb_cuda(points, centers, xsq, min_in, labels, *,
                          mode: str, p: int, bn: int = None):
    """Grouped round on the card.  points (n, d), centers (m, bc, d), xsq
    (n,) squared norms (euclidean modes; None otherwise), min_in (n,) (each
    row's distance to its own group's selected centers), labels (n,) int32
    (a label outside [0, m) matches no group) -> (min_out (n,), cand_val
    (m, p), cand_idx (m, p) int64): every group's exact top-p of the updated
    field over its own rows.  A group with fewer than p rows ends in -inf
    entries whose indices lie in [0, n)."""
    bn = grouped_tile_rows(p) if bn is None else bn
    _check_grouped(points, centers, xsq, min_in, labels, mode, p, bn)
    n, d = points.shape
    m, bc, _ = centers.shape
    # the centers' squared norms as the plain version computes them, and
    # the centers in float64, converted once a sweep into the kernel's
    # scratch, its rows zero-padded to a multiple of 16
    cflat = centers.view(m * bc, d)
    csq = torch.sum(cflat * cflat, dim=-1) if xsq is not None else None
    c64 = torch.zeros((m, bc, -(-d // 16) * 16), dtype=torch.float64,
                      device=points.device)
    c64[:, :, :d] = centers
    tiles = -(-n // bn)
    min_out = torch.empty_like(min_in)
    tile_val = torch.empty((m, tiles * p), dtype=torch.float32,
                           device=points.device)
    tile_idx = torch.empty((m, tiles * p), dtype=torch.int32,
                           device=points.device)
    vec = int(d % 4 == 0 and points.data_ptr() % 16 == 0)
    lib = build.library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.repro_grouped_sweep(
            points.data_ptr(), 0 if xsq is None else xsq.data_ptr(),
            c64.data_ptr(), 0 if csq is None else csq.data_ptr(),
            min_in.data_ptr(), labels.data_ptr(), min_out.data_ptr(),
            tile_val.data_ptr(), tile_idx.data_ptr(), n, d, m, bc, p,
            MODES[mode], bn, vec, stream)
    build.check(rc)
    build.LAUNCHES["gmm_grouped_topb"] += 1
    vals, idx = merge_tiles_grouped(tile_val, tile_idx.long(), p)
    return min_out, vals, idx
