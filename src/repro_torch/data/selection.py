"""Diversity-driven data selection (port of ``repro.data.selection``).

Given a pool of examples, embed them (mean-pooled token embeddings through
a model's own embedding table, or a seeded random-projection sketch of
token histograms when no model is at hand), then pick the k most diverse
with the core-set machinery: the "diverse subset for curation / dedup"
loop the paper motivates.  ``embed_examples`` returns a tensor on the
device; ``select_diverse`` is the legacy spelling of ``diversify`` (batch,
or MapReduce with ``num_reducers > 1``).  ``_match_rows`` recovers the row
ids of a selection; ``balanced_quotas`` splits k across labelled groups.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, to_numpy


def _tokens(token_batches, device) -> torch.Tensor:
    if isinstance(token_batches, torch.Tensor):
        return token_batches.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(token_batches), dtype=torch.long,
                           device=device)


def embed_examples(token_batches, embedding=None, dim: int = 64,
                   seed: int = 0, *, device=None,
                   chunk: int = 2048) -> torch.Tensor:
    """token_batches (N, S) int -> (N, dim) float32 embeddings on the device
    (default: the table's device when ``embedding`` is a tensor, else the
    tokens' when they are one, else the card).

    With ``embedding`` (a (V, D) table, e.g. a model's ``embed``), each row
    is the mean of its tokens' table rows in fp32, summed in token order
    ``chunk`` examples at a time, so no (N, S, D) gather is ever held; when
    D > dim the means go through the reference's seeded (D, dim) projection.
    Without it, each row is the sum of a seeded (vmax, dim) random
    projection's rows over its tokens (a token-histogram sketch), one
    ``embedding_bag``.  The projections are the reference's numpy draws, in
    the dtype numpy gives them."""
    like = embedding if isinstance(embedding, torch.Tensor) else token_batches
    dev = resolve_device(device, like=like)
    toks = _tokens(token_batches, dev)
    if embedding is not None:
        emb = embedding.to(dev) if isinstance(embedding, torch.Tensor) \
            else torch.as_tensor(np.asarray(embedding, np.float32), device=dev)
        N, S = toks.shape
        pooled = torch.empty((N, emb.shape[1]), dtype=torch.float32,
                             device=dev)
        for c0 in range(0, N, chunk):
            rows, acc = toks[c0:c0 + chunk], pooled[c0:c0 + chunk]
            acc.copy_(emb.index_select(0, rows[:, 0]))
            for s in range(1, S):
                acc.add_(emb.index_select(0, rows[:, s]))
            acc.div_(S)
        if pooled.shape[1] > dim:
            rng = np.random.default_rng(seed)
            proj = rng.normal(size=(pooled.shape[1], dim)).astype(np.float32)
            proj /= np.sqrt(pooled.shape[1])
            pooled = pooled @ torch.as_tensor(proj, device=dev)
        return pooled
    # seeded random-projection sketch of token histograms
    rng = np.random.default_rng(seed)
    vmax = int(toks.max()) + 1
    proj = rng.normal(size=(vmax, dim)).astype(np.float32) / np.sqrt(vmax)
    sketch = torch.nn.functional.embedding_bag(
        toks, torch.as_tensor(proj, device=dev), mode="sum")
    return sketch.to(torch.float32)


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


def select_diverse(embeddings, k: int, *, measure="remote-edge",
                   kprime=None, num_reducers: int = 1,
                   metric="euclidean", group_labels=None, quotas=None,
                   matroid=None, b=1, chunk: int = 0,
                   eps: float = 0.1, tau=None, cliff=None, device=None,
                   use_pallas="auto") -> np.ndarray:
    """Returns indices of the k selected examples.

    Legacy spelling of ``repro_torch.diversify`` (whose ``DiversityResult``
    also carries the row ``indices``) — prefer the facade for new code.
    ``num_reducers > 1`` runs the simulated MapReduce scheme (round 1 of
    all reducers one grouped sweep a fold).  ``group_labels`` makes the
    selection matroid-constrained: ``quotas=`` exact per-group counts
    (default a balanced split of k), or ``matroid=`` any
    ``constrained.matroid`` oracle.  ``b``/``chunk``/``kprime``/``eps``
    tune the engine (``b=1`` exact GMM; ``b="auto"`` / ``kprime="auto"``
    the radius-certified adaptive engine).  ``device``: the embeddings'
    device when they are a tensor, else the card; ``use_pallas`` as in
    ``ExecutionSpec``.

    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> emb = rng.normal(size=(200, 8)).astype(np.float32)
    >>> idx = select_diverse(emb, 8, device="cpu")
    >>> len(idx) == len(set(idx.tolist())) == 8
    True
    """
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify

    _warn_legacy("repro_torch.data.select_diverse")
    dev = resolve_device(device, like=embeddings)
    res = diversify(
        ProblemSpec(points=embeddings, k=k, measure=measure, metric=metric,
                    labels=group_labels, matroid=matroid, quotas=quotas),
        ExecutionSpec(mode="mapreduce" if num_reducers > 1 else "batch",
                      num_reducers=num_reducers if num_reducers > 1 else None,
                      kprime=kprime, b=b, chunk=chunk, eps=eps, tau=tau,
                      cliff=cliff, device=str(dev), use_pallas=use_pallas))
    return res.indices


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
