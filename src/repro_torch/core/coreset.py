"""Core-set containers + the single-machine construction (port of
``repro.core.coreset``).

``Coreset``            — explicit point core-set (fixed capacity + validity
                         mask).
``GeneralizedCoreset`` — kernel points + multiplicities (§6 of the paper).

Fields are tensors on the points' device; ``compact`` keeps them there (the
solver copies only the core-set-sized distance matrix to the host).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_points, resolve_device, to_numpy


class Coreset(NamedTuple):
    points: torch.Tensor     # (cap, d)
    valid: torch.Tensor      # (cap,) bool
    weights: torch.Tensor    # (cap,) int32  (1 for valid rows, 0 otherwise)
    radius: torch.Tensor     # () — proxy-distance bound r_T (telemetry)
    cert: Optional[object] = None  # RadiusCertificate (adaptive/auto paths)

    def compact(self) -> torch.Tensor:
        """The valid rows (dynamic shape, on the core-set's device)."""
        return self.points[self.valid]

    @property
    def size(self) -> int:
        return int(self.valid.sum())


class GeneralizedCoreset(NamedTuple):
    points: torch.Tensor        # (kprime, d) kernel
    multiplicity: torch.Tensor  # (kprime,) int32 (0 = invalid row)
    radius: torch.Tensor        # () — delegate distance bound (Lemma 7's δ)
    cert: Optional[object] = None  # RadiusCertificate (adaptive/auto paths)

    def compact(self):
        """(kernel points kept on device, host multiplicities) of the rows
        with multiplicity > 0."""
        m = to_numpy(self.multiplicity)
        keep = torch.as_tensor(m > 0, device=self.points.device)
        return self.points[keep], m[m > 0]

    @property
    def expanded_size(self) -> int:
        return int(self.multiplicity.sum())


def coreset_from_points(points, weights=None, *, device=None) -> Coreset:
    points = as_points(points, device)
    n = points.shape[0]
    weights = (torch.ones((n,), dtype=torch.int32, device=points.device)
               if weights is None else
               torch.as_tensor(weights, dtype=torch.int32,
                               device=points.device))
    return Coreset(points=points,
                   valid=torch.ones((n,), dtype=torch.bool,
                                    device=points.device),
                   weights=weights,
                   radius=torch.zeros((), dtype=points.dtype,
                                      device=points.device))


def build_coreset(points, k: int, kprime, measure: str, *,
                  metric="euclidean", use_pallas="auto",
                  generalized: bool = False, b=1, chunk: int = 0,
                  eps: float = 0.1, schedule=None, tau=None, cliff=None,
                  sprint="auto", device=None):
    """Sequential (single-partition) core-set per the paper's recipe:

    * remote-edge / remote-cycle  -> GMM(S, k')            (Thm 4)
    * the other four              -> GMM-EXT(S, k, k')     (Thm 5)
    * generalized=True            -> GMM-GEN(S, k, k')     (Thm 10)

    ``b``/``chunk`` select the batched lookahead-b engine, ``b="auto"`` the
    radius-certified adaptive controller and ``kprime="auto"`` grows k'
    until the measured radius certificate meets ``eps``; both attach the
    ``RadiusCertificate`` as ``cs.cert``.  ``use_pallas="auto"`` runs the
    CUDA sweep kernels on a CUDA device.
    """
    from .gmm import (effective_block, gmm as _gmm, gmm_batched,
                      gmm_ext as _gmm_ext, gmm_ext_from_kernel,
                      gmm_gen as _gmm_gen)
    from .measures import NEEDS_INJECTIVE

    points = as_points(points, device)
    auto = kprime == "auto" or b == "auto"
    cert = None
    if kprime == "auto":
        from .adaptive import auto_kprime
        res = auto_kprime(points, k, eps, measure, metric=metric, b=b,
                          chunk=chunk, use_pallas=use_pallas, tau=tau,
                          cliff=cliff, sprint=sprint)
        kprime, cert = int(res.idx.shape[0]), res.cert
        kernel = res
    elif b == "auto":
        from .adaptive import gmm_adaptive
        kernel = gmm_adaptive(points, kprime, metric=metric, chunk=chunk,
                              use_pallas=use_pallas, tau=tau, cliff=cliff,
                              scale_count=min(k, kprime), sprint=sprint)
        cert = kernel.cert
    if generalized:
        if auto:
            ext = gmm_ext_from_kernel(points, kernel.idx, kernel.radius, k,
                                      metric=metric, chunk=chunk,
                                      use_pallas=use_pallas)
            return GeneralizedCoreset(points=points[ext.kernel_idx],
                                      multiplicity=ext.multiplicity,
                                      radius=ext.radius, cert=cert)
        return _gmm_gen(points, k, kprime, metric=metric,
                        use_pallas=use_pallas, b=b, chunk=chunk,
                        schedule=schedule)
    if measure in NEEDS_INJECTIVE:
        if auto:
            ext = gmm_ext_from_kernel(points, kernel.idx, kernel.radius, k,
                                      metric=metric, chunk=chunk,
                                      use_pallas=use_pallas)
        else:
            ext = _gmm_ext(points, k, kprime, metric=metric,
                           use_pallas=use_pallas, b=b, chunk=chunk,
                           schedule=schedule)
        flat_idx = ext.delegate_idx.reshape(-1)
        flat_valid = ext.delegate_valid.reshape(-1)
        return Coreset(points=points[flat_idx], valid=flat_valid,
                       weights=flat_valid.to(torch.int32),
                       radius=ext.radius, cert=cert)
    if auto:
        return _dense_coreset(points[kernel.idx], kernel.radius, cert)
    if schedule is None:
        b = effective_block(kprime, b)
    if schedule is not None or b > 1 or chunk:
        idx, radius, _ = gmm_batched(points, kprime, b=b, metric=metric,
                                     chunk=chunk, use_pallas=use_pallas,
                                     schedule=schedule)
    else:
        res = _gmm(points, kprime, metric=metric, use_pallas=use_pallas)
        idx, radius = res.idx, res.radius
    return _dense_coreset(points[idx], radius, None)


def _dense_coreset(pts, radius, cert) -> Coreset:
    n = pts.shape[0]
    return Coreset(points=pts,
                   valid=torch.ones((n,), dtype=torch.bool, device=pts.device),
                   weights=torch.ones((n,), dtype=torch.int32,
                                      device=pts.device),
                   radius=torch.as_tensor(radius, device=pts.device),
                   cert=cert)


def diversity_maximize(points, k: int, measure: str, *, kprime=None,
                       metric="euclidean", use_pallas="auto", b=1,
                       chunk: int = 0, eps: float = 0.1, tau=None,
                       cliff=None, device=None):
    """End-to-end: core-set + sequential α-approx solver.

    Legacy spelling of ``repro_torch.diversify`` — prefer the facade for new
    code (this wrapper emits a ``DeprecationWarning`` and routes through
    it).  Returns (solution_points (k, d) ndarray, value, coreset).
    ``b="auto"`` and ``kprime="auto"`` run the radius-certified adaptive
    engine (``eps`` sets the auto-k' target), and the core-set then carries
    ``cs.cert``.  ``use_pallas`` defaults to ``"auto"`` (the kernels on the
    card), where the reference's ``False`` picks its XLA path; ``device``:
    the points' device when they are a tensor, else the card.

    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> pts = rng.normal(size=(1000, 3)).astype(np.float32)
    >>> sol, value, cs = diversity_maximize(pts, k=5, measure="remote-edge",
    ...                                     device="cpu")
    >>> sol.shape
    (5, 3)
    """
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify

    _warn_legacy("repro_torch.core.diversity_maximize")
    res = diversify(
        ProblemSpec(points=points, k=k, measure=measure, metric=metric),
        ExecutionSpec(mode="batch", kprime=kprime, b=b, chunk=chunk,
                      eps=eps, use_pallas=use_pallas, tau=tau, cliff=cliff,
                      device=str(resolve_device(device, like=points))))
    return res.solution, res.value, res.coreset
