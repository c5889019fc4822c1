"""Tiled pairwise distance on the card: ``(m, n)`` distances between the rows
of ``x`` and ``y`` in one launch, norm correction and transform fused.

Port of ``repro.kernels.pairwise.pairwise_pallas``; the CUDA body is
``csrc/pairwise.cu`` (see the note there on its bound, design and summation
order).  The streaming core-set's chunk filter and merge (``core/smm.py``)
and the batch path's assignment pass (``core/gmm._assign_to_centers``)
call it through ``ops.pairwise``.  The plain version is ``ref.pairwise_ref``.
"""
from __future__ import annotations

import torch

from . import build
from .gmm_topb import MODES
from .ref import pairwise_ref  # noqa: F401  (plain version)


def _check(x, y, xsq, ysq, mode):
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must be "
                         "(m, d) and (n, d)")
    if mode not in MODES:
        raise ValueError(f"no kernel mode {mode!r}")
    named = {"x": x, "y": y}
    if mode in ("sqeuclidean", "euclidean"):
        if xsq is None or ysq is None:
            raise ValueError(f"mode {mode!r} needs the squared norms xsq, ysq")
        if xsq.shape != (x.shape[0],) or ysq.shape != (y.shape[0],):
            raise ValueError("xsq and ysq must have shapes (m,) and (n,)")
        named.update(xsq=xsq, ysq=ysq)
    for name, t in named.items():
        if not t.is_cuda or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{x.device}")
    m, n = x.shape[0], y.shape[0]
    if min(m, n, x.shape[1]) < 1:
        raise ValueError("empty input")
    if max(m, n, x.shape[1]) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's int32 sizes")


def pairwise_cuda(x, y, xsq=None, ysq=None, *, mode: str):
    """Distance tile on the card.  x (m, d), y (n, d), xsq (m,) and ysq (n,)
    squared norms (euclidean modes; None otherwise) -> (m, n) float32.
    Cosine inputs are expected normalized (``ops.pairwise`` does it)."""
    _check(x, y, xsq, ysq, mode)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_pairwise(
            x.data_ptr(), y.data_ptr(),
            0 if xsq is None else xsq.data_ptr(),
            0 if ysq is None else ysq.data_ptr(),
            out.data_ptr(), m, n, d, MODES[mode], stream)
    build.check(rc)
    build.LAUNCHES["pairwise"] += 1
    return out
