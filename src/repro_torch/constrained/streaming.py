"""Streaming matroid-constrained diversity: one SMM state per group (port of
``repro.constrained.streaming``).

Running the paper's streaming construction independently per group and
taking the union yields a core-set of the constrained problem for any
label-count matroid (see ``constrained.coreset``).  Each ``(chunk, labels)``
pair is split by label on the device: the group ids are read once per chunk
on the host, from the labels the caller passes, and one stable permutation
of the chunk's rows (``index_select``) lays the groups out one after the
other in arrival order; each group's slice then goes through the port's
``StreamingCoreset`` unchanged (one distance tile per group and chunk,
through the B3 kernel on the card).
"""
from __future__ import annotations

from dataclasses import replace as dataclasses_replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.smm import StreamingCoreset
from ..device import as_points, resolve_device, to_numpy


class FairStreamingCoreset:
    """Per-group streaming core-sets for a label-count matroid over m groups.

    Usage::

        smm = FairStreamingCoreset(m=3, k=6, kprime=64, dim=8)
        for chunk, labels in labelled_stream:
            smm.update(chunk, labels)
        pts, labels = smm.finalize()        # union, tagged with group ids

    ``matroid=`` derives ``m``/``k`` from any ``constrained.matroid`` oracle
    (the stream-side state is the same; the oracle only matters to the
    solver).  ``device`` defaults to the card (a missing one raises) and
    ``use_pallas="auto"`` runs the distance tiles through the B3 kernel
    there.  Every group keeps k' slots sized for the total ``k``: a feasible
    solution takes at most k points from one group.  ``mode`` is ``"plain"``
    or ``"ext"``: the union is a set of points, so a stream of
    multiplicities (``"gen"``) has no constrained form.
    """

    def __init__(self, m: Optional[int] = None, k: Optional[int] = None,
                 kprime: int = 64, dim: int = 0, *, matroid=None,
                 metric="euclidean", mode: str = "plain",
                 eps: Optional[float] = None, device=None,
                 use_pallas="auto"):
        from .matroid import derive_mk

        m, k = derive_mk(matroid, m, k, "FairStreamingCoreset")
        if dim <= 0:
            raise ValueError("FairStreamingCoreset needs a positive dim")
        if m < 1:
            raise ValueError(f"need m >= 1 groups, got {m}")
        if mode not in ("plain", "ext"):
            raise ValueError(f"a constrained stream keeps points: mode must "
                             f"be 'plain' or 'ext', got {mode!r}")
        self.m, self.k, self.kprime, self.dim = m, k, kprime, dim
        self.metric, self.mode = metric, mode
        self.eps = eps           # accuracy target recorded per-group cert
        self.device = resolve_device(device)
        self._per_group = [
            StreamingCoreset(k=k, kprime=kprime, dim=dim, metric=metric,
                             mode=mode, eps=eps, device=self.device,
                             use_pallas=use_pallas)
            for _ in range(m)
        ]
        self.n_seen = 0

    def update(self, chunk, labels) -> None:
        """Feed one chunk (``(c, dim)`` array or tensor) with its ``(c,)``
        group labels in ``[0, m)``."""
        chunk = as_points(chunk, self.device)
        if chunk.ndim < 2:
            chunk = chunk.reshape(1, -1)
        labels = np.atleast_1d(np.asarray(to_numpy(labels))).astype(np.int64)
        if labels.shape[0] != chunk.shape[0]:
            raise ValueError(f"chunk rows {chunk.shape[0]} != labels "
                             f"{labels.shape[0]}")
        bad = (labels < 0) | (labels >= self.m)
        if bad.any():
            raise ValueError(f"label {int(labels[bad][0])} out of range for "
                             f"m={self.m}")
        self.n_seen += chunk.shape[0]
        sizes = np.bincount(labels, minlength=self.m)
        order = np.argsort(labels, kind="stable")
        grouped = chunk.index_select(
            0, torch.as_tensor(order, device=chunk.device))
        start = 0
        for g in np.flatnonzero(sizes):
            self._per_group[g].update(grouped[start:start + sizes[g]])
            start += int(sizes[g])

    def finalize(self) -> Tuple[torch.Tensor, np.ndarray]:
        """Returns (points (N, dim) on the stream's device, labels (N,)
        int32 on the host) — the union core-set.  A group that streamed
        fewer than k points contributes all of them; an empty group
        contributes nothing (its quota must be 0 downstream)."""
        pts_parts, lab_parts = [], []
        for g, smm in enumerate(self._per_group):
            if smm.n_seen == 0:
                continue
            pts = smm.finalize(allow_small=True).compact()
            pts_parts.append(pts)
            lab_parts.append(np.full((pts.shape[0],), g, np.int32))
        if not pts_parts:
            return (torch.zeros((0, self.dim), device=self.device),
                    np.zeros((0,), np.int32))
        return torch.cat(pts_parts), np.concatenate(lab_parts)

    @property
    def state(self):
        """The per-group SMM states (None for a group not booted yet)."""
        return [smm.state for smm in self._per_group]

    @property
    def radius(self) -> float:
        """Max per-group proxy radius (4·d_i of each live SMM state)."""
        r = 0.0
        for smm in self._per_group:
            state = smm.state
            if state is not None:
                r = max(r, 4.0 * float(state.d_thr))
        return r

    def certificates(self):
        """Per-group streaming ``RadiusCertificate``s (see
        ``StreamingCoreset.certificate``); empty groups are skipped."""
        return {g: smm.certificate()
                for g, smm in enumerate(self._per_group) if smm.n_seen > 0}

    def certificate(self):
        """Worst-group combined certificate: the union core-set's proxy
        error is the max group radius, and its certified ratio the max
        group ratio, with every group's ratio in ``group_ratios``."""
        from ..core.adaptive import RadiusCertificate

        per = self.certificates()
        if not per:
            return RadiusCertificate(kprime=self.kprime, radius=0.0,
                                     scale=0.0, ratio=0.0,
                                     eps_target=self.eps, kind="streaming")
        worst = max(per.values(), key=lambda c: c.ratio)
        return dataclasses_replace(
            worst, group_ratios=tuple(per[g].ratio if g in per else 0.0
                                      for g in range(self.m)))


def fair_streaming_diversity(points, labels, quotas=None, *, matroid=None,
                             measure: str = "remote-edge",
                             kprime: Optional[int] = None, chunk: int = 4096,
                             metric="euclidean", mode: Optional[str] = None,
                             swap_rounds: int = 10, device=None,
                             use_pallas="auto"):
    """End-to-end single-pass streaming driver.

    Legacy spelling of ``repro_torch.diversify`` with ``ExecutionSpec(
    mode="streaming")`` — prefer the facade for new code.  Streams
    ``points``/``labels`` in chunks through per-group SMM states and solves
    on the union with the matroid oracle (``quotas=`` is sugar for an
    exact-quota ``PartitionMatroid``).  Returns (solution_points (k, d),
    solution_labels).  ``device``: the points' device when they are a
    tensor, else the card.
    """
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify
    from .matroid import as_matroid

    _warn_legacy("repro_torch.constrained.fair_streaming_diversity")
    mat = as_matroid(matroid, quotas)
    res = diversify(
        ProblemSpec(points=points, k=mat.k, measure=measure, metric=metric,
                    labels=labels, matroid=mat),
        ExecutionSpec(mode="streaming", kprime=kprime, chunk=chunk,
                      smm_mode=mode, swap_rounds=swap_rounds,
                      device=str(resolve_device(device, like=points)),
                      use_pallas=use_pallas))
    return res.solution, res.labels
