"""Public wrappers around the sweep kernels (port of
``repro.kernels.ops``).

They map a metric name to a kernel mode (cosine pre-normalizes so the
kernel is a pure dot + arccos), keep ``bn >= p`` and clamp indices to
``n - 1``.  A wrapper launches the CUDA kernel for CUDA tensors and runs
the plain torch version (``kernels.ref``) only because the tensors it was
given lie on the CPU; there is no switch that swaps the kernel out.

``pairwise`` is the distance tile (B3) of the streaming core-set and the
assignment pass; ``grouped_gmm_topb`` the grouped sweep (B4) of the
constrained engine.  ``prepare`` computes the loop invariants of a run
(normalized points for cosine, squared norms for the euclidean modes) once;
engines pass them back in with ``prepared=True`` so no sweep re-reads the
points to recompute them.  ``LAUNCHES`` counts kernel launches per
wrapper.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import ref
from .build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .gmm_topb import gmm_topb_cuda
from .gmm_update import gmm_grouped_topb_cuda, gmm_update_select_cuda
from .pairwise import pairwise_cuda


def _metric_to_mode(metric_name: str):
    """-> (mode, needs_normalize)."""
    if metric_name in ("euclidean", "sqeuclidean", "dot"):
        return metric_name, False
    if metric_name == "cosine":
        return "cosine", True
    raise ValueError(f"no kernel path for metric {metric_name!r}")


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-30)


class Prepared(NamedTuple):
    """Per-run sweep invariants: the points as the kernel reads them and
    their squared norms (None for the dot/cosine modes)."""
    points: torch.Tensor
    xsq: Optional[torch.Tensor]


def prepare(points, metric_name: str) -> Prepared:
    """Loop invariants of a sweep run, computed once."""
    mode, norm = _metric_to_mode(metric_name)
    x = points.to(torch.float32).contiguous()
    if norm:
        x = _normalize(x)
    xsq = (torch.sum(x * x, dim=-1)
           if mode in ("sqeuclidean", "euclidean") else None)
    return Prepared(x, xsq)


def _inputs(points, centers, metric_name, xsq, prepared):
    mode, norm = _metric_to_mode(metric_name)
    centers = torch.atleast_2d(centers.to(torch.float32)).contiguous()
    if not prepared:
        points, xsq = prepare(points, metric_name)
        if norm:
            centers = _normalize(centers)
    return mode, points, centers, xsq


def pairwise(x, y, metric_name: str = "sqeuclidean", *, xsq=None, ysq=None,
             prepared: bool = False):
    """Distance matrix (m, n) between the rows of x and y (port of
    ``repro.kernels.ops.pairwise``): the B3 kernel for CUDA tensors, its
    plain version ``ref.pairwise_ref`` for CPU tensors.

    Cosine normalizes both sides first; the euclidean modes compute the
    squared norms not passed in.  With ``prepared=True`` the rows are
    already in kernel form (``prepare``) and ``xsq``/``ysq`` carry their
    squared norms: a caller that meets the same rows again (the streaming
    core-set's centers) passes them in and every call sees the same values.
    Nothing is padded or copied.
    """
    mode, norm = _metric_to_mode(metric_name)
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if not prepared and norm:
        x, y = _normalize(x), _normalize(y)
    if mode in ("sqeuclidean", "euclidean"):
        xsq = torch.sum(x * x, dim=-1) if xsq is None else xsq
        ysq = torch.sum(y * y, dim=-1) if ysq is None else ysq
    else:
        xsq = ysq = None
    if x.is_cuda:
        return pairwise_cuda(x, y, xsq, ysq, mode=mode)
    return ref.pairwise_ref(x, y, mode, xsq=xsq, ysq=ysq)


def gmm_update_select(points, centers, min_in, mask, metric_name: str,
                      bn: int = None, *, xsq=None, prepared: bool = False):
    """Fused GMM round on (n, d) points vs (b, d) centers.

    Returns (min_out (n,), argmax () int64, max ()).  With
    ``prepared=True`` the points (and centers) are already in kernel form
    (``prepare``) and ``xsq`` carries their squared norms.
    """
    mode, points, centers, xsq = _inputs(points, centers, metric_name, xsq,
                                         prepared)
    min_in = min_in.to(torch.float32).contiguous()
    if points.is_cuda:
        return gmm_update_select_cuda(points, centers, xsq, min_in, mask,
                                      mode=mode, bn=bn)
    return ref.gmm_update_select_ref(points, centers, min_in, mask, mode,
                                     xsq=xsq)


def gmm_update(points, center, min_in, metric_name: str):
    """Running-min only (port of ``repro.kernels.ops.gmm_update``, the
    compat wrapper of the lax GMM path): ``gmm_update_select`` with every
    row masked in, its ``min_out`` (n,)."""
    mask = torch.ones((points.shape[0],), dtype=torch.bool,
                      device=points.device)
    return gmm_update_select(points, center, min_in, mask, metric_name)[0]


def gmm_topb(points, centers, min_in, mask, metric_name: str,
             p: int = None, bn: int = None, *, xsq=None,
             prepared: bool = False):
    """Fused batched GMM round on (n, d) points vs (b, d) centers.

    Returns (min_out (n,), cand_val (p,), cand_idx (p,)) — the exact global
    top-p of the updated masked min-distance field (``p`` defaults to b).
    Candidate indices always index the original n points.
    """
    mode, points, centers, xsq = _inputs(points, centers, metric_name, xsq,
                                         prepared)
    min_in = min_in.to(torch.float32).contiguous()
    n = points.shape[0]
    p = centers.shape[0] if p is None else p
    if points.is_cuda:
        out = gmm_topb_cuda(points, centers, xsq, min_in, mask, mode=mode,
                            p=p, bn=bn)
    else:
        out = ref.gmm_topb_ref(points, centers, min_in, mask, mode, p,
                               xsq=xsq)
    min_out, vals, idx = out
    if vals.shape[0] < p:
        # p > n: the kernel's tile holds p rows, the pad rows entering as
        # -inf after every real row; their indices clamp to n - 1 below
        fill = p - vals.shape[0]
        vals = torch.cat([vals, vals.new_full((fill,), float("-inf"))])
        idx = torch.cat([idx, idx.new_full((fill,), n - 1)])
    return min_out, vals, torch.clamp(idx, max=n - 1)


def grouped_gmm_topb(points, centers, min_in, labels, metric_name: str,
                     b: int, bn: int = None, *, xsq=None, csq=None,
                     prepared: bool = False):
    """Fused group-blocked batched GMM round (the constrained engine's
    sweep, port of ``repro.kernels.ops.grouped_gmm_topb``).

    points (n, d), centers (m, bc, d), min_in (n,) (own-group running min),
    labels (n,) in [0, m) (-1 matches no group: such a row keeps its
    min_in and is never a candidate) -> (min_out (n,), cand_val (m, b),
    cand_idx (m, b)): one sweep serves all m groups, each row folding only
    its own group's block.  Indices always lie in [0, n).  With
    ``prepared=True`` the points and centers are already in kernel form
    (``prepare``) and ``xsq`` carries the points' squared norms; ``csq``
    optionally carries the centers' (m·bc,) squared norms (computed from
    the centers when not given).
    """
    mode, norm = _metric_to_mode(metric_name)
    centers = centers.to(torch.float32)
    if not prepared:
        points, xsq = prepare(points, metric_name)
        if norm:
            centers = _normalize(centers)
    centers = centers.contiguous()
    min_in = min_in.to(torch.float32).contiguous()
    labels = torch.as_tensor(labels, device=points.device).to(
        torch.int32).contiguous()
    n = points.shape[0]
    if points.is_cuda:
        min_out, vals, idx = gmm_grouped_topb_cuda(
            points, centers, xsq, min_in, labels, mode=mode, p=b, bn=bn,
            csq=csq)
    else:
        min_out, vals, idx = ref.gmm_grouped_topb_ref(
            points, centers, min_in, labels, mode, b, xsq=xsq, csq=csq)
    if vals.shape[1] < b:
        # b > n: as in the reference, the pad rows enter as -inf after
        # every real row; their indices clamp to n - 1 below
        fill = b - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], fill),
                                              float("-inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((idx.shape[0], fill), n - 1)],
                        dim=1)
    return min_out, vals, torch.clamp(idx, max=n - 1)
