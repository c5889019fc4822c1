"""Serving-time diversity: the fused multi-tenant rerank and the session
reranker over streaming core-sets (port of ``repro.serving.rerank``).

* ``rerank_batched`` — the stateless hot path.  A decode step's worth of
  concurrent requests (each with its own candidate embeddings) is ONE run
  of the grouped selection engine (``core.gmm._schedule_select_impl``) with
  labels = request id and schedule ``((1, k),)``: b = 1 is exact
  sequential GMM per request (the paper's α=2 sequential solver for the
  GMM-prefix measures), and every fold of all R requests is one grouped
  sweep, the B4 kernel on the card (the reference vmaps the m=1 engine over
  the requests instead).  Ragged candidate sets are padded with rows
  labelled −1, which match no request and are never selected.  The slates'
  (R, k, k) distance matrices are one batched product of the port's
  metric.

* ``OnlineReranker`` + ``SessionStore`` — the stateful path.  Each session
  keeps ONE ``StreamingCoreset`` (or ``FairStreamingCoreset`` under a
  matroid) that absorbs every request's candidates (its chunk filter is the
  B3 kernel on the card) and re-certifies incrementally; when a request
  leaves the core-set unchanged (the SMM ``generation`` token), the cached
  slate is returned (``coreset_reuses``).  ``rerank_many`` solves every
  changed plain-mode session in one grouped engine run over the stacked
  ``(k'+1, d)`` center sets, one B4 launch a fold.  Sessions are evicted
  LRU under a byte budget and survive kills through
  ``checkpoint.CheckpointManager``.

Counters (``repro_torch.obs``): ``sessions_active`` (sessions opened),
``rerank_batched`` (requests served by a fused run), ``coreset_reuses``
(requests answered from the cached slate).

The port keeps the self-distances of the factorized euclidean form (they
are not zeroed), so a slate value that sums a distance matrix's diagonal
(remote-star and kin) carries them, as the port's other measures do.

>>> import numpy as np
>>> from repro_torch.serving import OnlineReranker
>>> rng = np.random.default_rng(0)
>>> rr = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
>>> for step in range(3):                      # three requests, one session
...     out = rr.rerank("user-1", rng.normal(size=(64, 8)).astype(np.float32))
>>> out.slate.shape
(4, 8)
>>> out.cert.kind
'streaming'
>>> rr.store.active
1
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_points, resolve_device, resolve_use_pallas, to_numpy
from ..kernels.build import LAUNCHES
from ..obs.trace import count as _count, launch_span as _launch_span

#: measures whose sequential α-approx solver is a GMM prefix — exactly the
#: set the fused engine can answer per request (remote-clique runs a
#: matching solver instead; see core.sequential).
GMM_PREFIX_MEASURES = ("remote-edge", "remote-star", "remote-bipartition",
                       "remote-tree", "remote-cycle")


# --------------------------------------------------------------------------
# fused multi-tenant rerank (stateless hot path)
# --------------------------------------------------------------------------

def _fused_select(points, labels, starts, k: int, chunk: int,
                  metric_name: str, use_pallas: bool):
    """Exact b=1 GMM of every group of ``points`` (G, c, d) at once: one
    grouped-engine run over the flattened rows, labels (G, c) holding the
    group id of a row or −1 for a row that is never selected, each group
    seeded at its row ``starts[g]`` (a valid one).  Returns (idx (G, k)
    rows into each group, radius (G,) anticover radius after k picks,
    dm (G, k, k) slate distances), on the points' device."""
    from ..core.gmm import _schedule_select_impl, _sweep_points
    from ..core.metrics import get_metric

    G, c, d = points.shape
    flat = points.reshape(G * c, d)
    offsets = torch.arange(G, device=flat.device) * c
    idx, radius, _, _, _ = _schedule_select_impl(
        _sweep_points(flat, metric_name), flat, labels.reshape(-1),
        offsets + torch.as_tensor(starts, device=flat.device), G, k,
        ((1, k),), chunk, metric_name, use_pallas, grouped=True)
    slate = flat[idx]
    dm = get_metric(metric_name).pairwise(slate, slate)
    return idx - offsets[:, None], radius, dm


@dataclasses.dataclass(frozen=True)
class BatchedRerank:
    """One fused run's worth of per-request diverse slates."""
    indices: np.ndarray         # (R, k) rows into each request's candidates
    radii: np.ndarray           # (R,) anticover radius of each slate
    values: np.ndarray          # (R,) diversity objective of each slate


def _stack_ragged(batches: Sequence, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Stack per-request candidate sets of possibly different lengths into
    one (R, n_max, d) tensor on ``device`` + (R, n_max) engine labels (the
    request id; -1 = padding) + the request sizes."""
    arrs = [as_points(b, device) for b in batches]
    arrs = [a.reshape(1, -1) if a.ndim < 2 else a for a in arrs]
    d = arrs[0].shape[1]
    for i, a in enumerate(arrs):
        if a.shape[1] != d:
            raise ValueError(f"request {i} has dim {a.shape[1]}, expected {d}")
    n_max = max(a.shape[0] for a in arrs)
    dev = arrs[0].device
    pts = torch.zeros((len(arrs), n_max, d), dtype=torch.float32, device=dev)
    lab = torch.full((len(arrs), n_max), -1, dtype=torch.int32, device=dev)
    sizes = []
    for i, a in enumerate(arrs):
        pts[i, :a.shape[0]] = a
        lab[i, :a.shape[0]] = i
        sizes.append(a.shape[0])
    return pts, lab, sizes


def rerank_batched(candidates, k: int, *, measure: str = "remote-edge",
                   metric: str = "euclidean", chunk: int = 0, device=None,
                   use_pallas="auto") -> BatchedRerank:
    """Diverse top-``k`` for a whole group of concurrent requests in ONE
    fused engine run.

    ``candidates`` is a list of per-request ``(n_i, d)`` candidate-embedding
    arrays or tensors (ragged allowed — shorter sets are padded with
    never-selectable rows) or a single ``(R, n, d)`` array or tensor.  Each
    request gets an exact sequential-GMM slate (the α=2 sequential solver
    for ``remote-edge`` and the other GMM-prefix measures); on the card
    every fold of all R requests is one B4 launch.  ``device`` defaults to
    the tensor's own device, else the card.  ``chunk`` is accepted for the
    reference's signature (the port's sweeps tile by themselves).

    Returns ``BatchedRerank(indices (R, k), radii (R,), values (R,))``.

    >>> import numpy as np
    >>> from repro_torch.serving import rerank_batched
    >>> rng = np.random.default_rng(0)
    >>> cands = [rng.normal(size=(32, 4)).astype(np.float32)
    ...          for _ in range(8)]
    >>> out = rerank_batched(cands, k=3, device="cpu")
    >>> out.indices.shape
    (8, 3)
    >>> bool((out.values > 0).all())
    True
    """
    from ..core.measures import MEASURES, diversity
    from ..core.metrics import get_metric

    if measure not in MEASURES:
        raise ValueError(f"unknown measure {measure!r}")
    if measure not in GMM_PREFIX_MEASURES:
        raise ValueError(
            f"rerank_batched solves per-request slates with the GMM-prefix "
            f"engine; measure {measure!r} needs a matching solver — use "
            f"repro_torch.diversify(mode='batch') per request instead")
    metric_name = get_metric(metric).name
    if getattr(candidates, "ndim", 0) == 3:
        pts = as_points(candidates, device)
        R, n, _ = pts.shape
        sizes = [n] * R
        lab = torch.arange(R, dtype=torch.int32, device=pts.device)[
            :, None].expand(R, n).contiguous()
    else:
        pts, lab, sizes = _stack_ragged(list(candidates), device)
    R, n, _ = pts.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for candidate sets of {n}")
    if min(sizes) < k:
        raise ValueError(f"every request needs >= k={k} candidates")
    use_pallas = resolve_use_pallas(use_pallas, pts.device, metric_name)
    # the span records the folds (k, one grouped sweep of all requests
    # each) and the kernel launches made inside it
    with _launch_span("serving.rerank_batched", LAUNCHES, requests=R,
                      folds=k):
        # every request's candidates begin at its row 0
        idx, radii, dm = _fused_select(pts, lab, np.zeros(R, np.int64), k,
                                       chunk, metric_name, use_pallas)
        idx, radii, dm = to_numpy(idx), to_numpy(radii), to_numpy(dm)
    _count("rerank_batched", R)
    _count("device_dispatches")
    _count("host_syncs")
    values = np.asarray([diversity(measure, dm[r]) for r in range(R)],
                        np.float64)
    return BatchedRerank(indices=idx, radii=radii, values=values)


# --------------------------------------------------------------------------
# session store (LRU + byte budget)
# --------------------------------------------------------------------------

def session_nbytes(coreset) -> int:
    """Deterministic per-session byte accounting: the SMM state a live
    session pins on the device (the reference's fp32 model, the planner's
    ``memory_budget_bytes`` core-set prediction)."""
    if hasattr(coreset, "_per_group"):        # FairStreamingCoreset
        return sum(session_nbytes(g) for g in coreset._per_group)
    cap, dim = coreset.cap, coreset.dim
    k_slots = coreset.k if coreset.mode == "ext" else 1
    # T + M (cap x dim fp32 each), delegates (cap x k_slots x dim), masks +
    # counts (cap x ~6 B), threshold/phase scalars
    return cap * dim * 4 * (2 + k_slots) + cap * 6 + 16


@dataclasses.dataclass
class Session:
    """One live session: its streaming core-set plus the cached slate."""
    key: str
    coreset: object              # StreamingCoreset | FairStreamingCoreset
    nbytes: int
    requests: int = 0
    cached_generation: int = -1
    cached: Optional["RerankResult"] = None

    @property
    def generation(self) -> int:
        cs = self.coreset
        if hasattr(cs, "_per_group"):
            return sum(g.generation for g in cs._per_group)
        return cs.generation


class SessionStore:
    """LRU session table under a byte budget.

    Every access moves the session to the MRU end; when the summed
    ``session_nbytes`` accounting exceeds ``memory_budget_bytes``, LRU
    sessions are evicted (their core-sets are dropped — a checkpointed
    session can be restored, an unchunked one re-accumulates).  With no
    budget the store only grows (callers own the lifecycle).
    """

    def __init__(self, memory_budget_bytes: Optional[int] = None):
        self.memory_budget_bytes = memory_budget_bytes
        self._sessions: "OrderedDict[str, Session]" = OrderedDict()
        self.evictions = 0

    @property
    def active(self) -> int:
        """Live sessions in the store (the gauge behind the monotone
        ``sessions_active`` counter)."""
        return len(self._sessions)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self._sessions.values())

    def get(self, key: str) -> Optional[Session]:
        sess = self._sessions.get(key)
        if sess is not None:
            self._sessions.move_to_end(key)
        return sess

    def put(self, sess: Session) -> None:
        self._sessions[sess.key] = sess
        self._sessions.move_to_end(sess.key)
        self._evict_to_budget(keep=sess.key)

    def pop(self, key: str) -> Optional[Session]:
        return self._sessions.pop(key, None)

    def keys(self):
        return list(self._sessions.keys())

    def _evict_to_budget(self, keep: Optional[str] = None) -> None:
        if self.memory_budget_bytes is None:
            return
        while self.nbytes > self.memory_budget_bytes and len(self._sessions) > 1:
            lru = next(iter(self._sessions))
            if lru == keep:            # never evict the request being served
                break
            self._sessions.pop(lru)
            self.evictions += 1


# --------------------------------------------------------------------------
# the online reranker
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RerankResult:
    """One session rerank: the k most diverse points of the session's
    cumulative candidate stream, with its carried certificate."""
    slate: np.ndarray                    # (k, d), on the host
    cert: object                         # RadiusCertificate
    reused: bool                         # True = served from the cached slate
    generation: int                      # core-set generation of the slate
    session: str
    labels: Optional[np.ndarray] = None  # (k,) group ids (constrained only)


class OnlineReranker:
    """Per-session online diverse rerank: one streaming core-set per session,
    re-certified incrementally, solved only when the core-set changed.

    ``matroid=`` switches sessions to ``FairStreamingCoreset`` (quota-fair
    slates via the constrained solver); otherwise the ``measure`` picks the
    SMM mode exactly like the planner (clique-type measures keep delegates).
    ``memory_budget_bytes`` bounds the session table (LRU eviction).
    ``device`` (default the card) holds every session's state;
    ``use_pallas="auto"`` runs the kernels there.

    ``rerank`` serves one request; ``rerank_many`` serves a whole concurrent
    group, solving every changed plain-mode session in one grouped engine
    run (the session core-sets share the fixed (k'+1, d) state shape, so
    they stack for free).
    """

    def __init__(self, k: int, dim: int, *, kprime: Optional[int] = None,
                 measure: str = "remote-edge", metric: str = "euclidean",
                 matroid=None, eps: Optional[float] = None,
                 memory_budget_bytes: Optional[int] = None, device=None,
                 use_pallas="auto"):
        from ..core.measures import MEASURES, NEEDS_INJECTIVE
        from ..core.metrics import get_metric

        if measure not in MEASURES:
            raise ValueError(f"unknown measure {measure!r}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k, self.dim = int(k), int(dim)
        self.kprime = max(2 * k, 32) if kprime is None else int(kprime)
        if self.kprime < k:
            raise ValueError("k' must be >= k")
        self.measure, self.metric = measure, metric
        self.matroid = matroid
        if matroid is not None and matroid.k != k:
            raise ValueError(f"matroid.k={matroid.k} != k={k}")
        self.smm_mode = "ext" if measure in NEEDS_INJECTIVE else "plain"
        self.eps = eps
        self.device = resolve_device(device)
        self.use_pallas = resolve_use_pallas(use_pallas, self.device,
                                             get_metric(metric).name)
        self.store = SessionStore(memory_budget_bytes)
        self.reuse_hits = 0
        self.requests_served = 0

    # -- sessions -----------------------------------------------------------
    def _open(self, key: str) -> Session:
        from ..constrained.streaming import FairStreamingCoreset
        from ..core.smm import StreamingCoreset

        if self.matroid is not None:
            cs = FairStreamingCoreset(matroid=self.matroid,
                                      kprime=self.kprime, dim=self.dim,
                                      metric=self.metric, mode=self.smm_mode,
                                      eps=self.eps, device=self.device,
                                      use_pallas=self.use_pallas)
        else:
            cs = StreamingCoreset(k=self.k, kprime=self.kprime, dim=self.dim,
                                  metric=self.metric, mode=self.smm_mode,
                                  eps=self.eps, device=self.device,
                                  use_pallas=self.use_pallas)
        sess = Session(key=key, coreset=cs, nbytes=session_nbytes(cs))
        self.store.put(sess)
        _count("sessions_active")
        return sess

    def _absorb(self, key: str, candidates, labels=None) -> Session:
        sess = self.store.get(key) or self._open(key)
        cands = as_points(candidates, self.device)
        if cands.ndim < 2:
            cands = cands.reshape(1, -1)
        if cands.shape[1] != self.dim:
            raise ValueError(f"candidates have dim {cands.shape[1]}, "
                             f"reranker was built for dim {self.dim}")
        with _launch_span("serving.absorb", LAUNCHES, session=key,
                          n=int(cands.shape[0])):
            if self.matroid is not None:
                if labels is None:
                    raise ValueError("constrained sessions need per-candidate "
                                     "labels")
                sess.coreset.update(cands, to_numpy(labels))
            else:
                sess.coreset.update(cands)
        sess.requests += 1
        self.requests_served += 1
        return sess

    # -- solving ------------------------------------------------------------
    def _solve_single(self, sess: Session) -> RerankResult:
        from ..constrained.solver import solve_and_value
        from ..core.sequential import solve_on_coreset

        if self.matroid is not None:
            pts, lab = sess.coreset.finalize()
            cert = sess.coreset.certificate()
            sel, _ = solve_and_value(pts, lab, measure=self.measure,
                                     matroid=self.matroid, metric=self.metric)
            return RerankResult(
                slate=to_numpy(pts[torch.as_tensor(sel, device=pts.device)]),
                cert=cert, reused=False, generation=sess.generation,
                session=sess.key, labels=np.asarray(lab[sel]))
        cs = sess.coreset.finalize()
        slate = solve_on_coreset(cs, self.k, self.measure, metric=self.metric)
        return RerankResult(slate=to_numpy(slate), cert=cs.cert,
                            reused=False, generation=sess.generation,
                            session=sess.key)

    def _solve_fused(self, sessions: List[Session]) -> List[RerankResult]:
        """One grouped engine run for every changed plain-mode session:
        their SMM states all hold (k'+1, d) centers, so the per-session
        k-center slates stack into a single b=1 GMM over S groups (one B4
        launch a fold on the card).  The host mirrors of the sessions'
        validity and threshold build the labels and certificates, so the
        run reads the device once, for the slates and their scales."""
        from ..core.adaptive import RadiusCertificate, _ratio
        from ..core.metrics import get_metric

        S, cap = len(sessions), self.kprime + 1
        pts = torch.zeros((S, cap, self.dim), dtype=torch.float32,
                          device=self.device)
        valid = np.zeros((S, cap), bool)
        d_thrs = np.zeros((S,), np.float64)
        for i, sess in enumerate(sessions):
            smm = sess.coreset
            if smm._booted:
                pts[i] = smm._T
                valid[i] = smm._valid_np
                d_thrs[i] = float(smm._d_thr)
            else:                               # pre-boot: prefix buffer
                pre = torch.cat(smm._prefix) if smm._prefix else pts[i, :0]
                pts[i, :pre.shape[0]] = pre
                valid[i, :pre.shape[0]] = True
        nv = valid.sum(axis=1)
        lab = np.where(valid, np.arange(S)[:, None], -1).astype(np.int32)
        with _launch_span("serving.solve_fused", LAUNCHES, sessions=S,
                          folds=self.k):
            # each session's GMM starts at its first valid center
            idx, scales, _ = _fused_select(
                pts, torch.as_tensor(lab, device=self.device),
                np.argmax(valid, axis=1), self.k, cap,
                get_metric(self.metric).name, self.use_pallas)
            slates = to_numpy(torch.gather(
                pts, 1, idx[:, :, None].expand(-1, -1, self.dim)))
            scales = to_numpy(scales).astype(np.float64)
        _count("rerank_batched", S)
        _count("device_dispatches")
        _count("host_syncs")
        out = []
        for i, sess in enumerate(sessions):
            smm = sess.coreset
            radius = 4.0 * d_thrs[i] if smm._booted else 0.0
            scale = float(scales[i]) if nv[i] >= self.k else 0.0
            ratio = _ratio(radius, scale)
            cert = RadiusCertificate(
                kprime=self.kprime, radius=radius, scale=scale, ratio=ratio,
                eps_target=smm.eps,
                meets_target=(None if smm.eps is None
                              else bool(ratio <= smm.eps)),
                counts=tuple(n for n, _ in smm.phase_log),
                radii=tuple(4.0 * t for _, t in smm.phase_log),
                kind="streaming")
            out.append(RerankResult(slate=slates[i], cert=cert, reused=False,
                                    generation=sess.generation,
                                    session=sess.key))
        return out

    def _can_fuse(self) -> bool:
        return (self.matroid is None and self.smm_mode == "plain"
                and self.measure in GMM_PREFIX_MEASURES)

    def _finish(self, sess: Session, res: RerankResult) -> RerankResult:
        sess.cached = res
        sess.cached_generation = res.generation
        return res

    def _cached(self, sess: Session) -> Optional[RerankResult]:
        if sess.cached is not None and sess.cached_generation == sess.generation:
            _count("coreset_reuses")
            self.reuse_hits += 1
            return dataclasses.replace(sess.cached, reused=True)
        return None

    # -- the request surface ------------------------------------------------
    def rerank(self, session: str, candidates, labels=None) -> RerankResult:
        """Absorb one request's candidate batch into ``session`` and return
        the k most diverse points of the session's cumulative stream.

        The ``RadiusCertificate`` rides along on every result; when the
        absorption left the core-set unchanged the previous slate (and its
        certificate) is returned outright — ``coreset_reuses`` counts those.
        """
        sess = self._absorb(session, candidates, labels)
        if sess.coreset.n_seen < self.k:
            raise ValueError(f"session {session!r} has seen "
                             f"{sess.coreset.n_seen} < k={self.k} candidates")
        hit = self._cached(sess)
        if hit is not None:
            return hit
        if self._can_fuse():
            res = self._solve_fused([sess])[0]
        else:
            res = self._solve_single(sess)
        return self._finish(sess, res)

    def rerank_many(self, batches: Mapping[str, object], labels=None
                    ) -> Dict[str, RerankResult]:
        """Serve a concurrent request group: absorb every session's batch,
        then solve all CHANGED plain-mode sessions in one fused run
        (unchanged sessions are served from their cached slates).

        ``batches`` maps session key -> candidate array or tensor;
        ``labels`` (same keys) rides along for constrained sessions.
        """
        out: Dict[str, RerankResult] = {}
        pending: List[Session] = []
        for key, cands in batches.items():
            sess = self._absorb(key, cands,
                                None if labels is None else labels.get(key))
            if sess.coreset.n_seen < self.k:
                raise ValueError(f"session {key!r} has seen "
                                 f"{sess.coreset.n_seen} < k={self.k} "
                                 f"candidates")
            hit = self._cached(sess)
            if hit is not None:
                out[key] = hit
            else:
                pending.append(sess)
        if pending:
            if self._can_fuse():
                for sess, res in zip(pending, self._solve_fused(pending)):
                    out[sess.key] = self._finish(sess, res)
            else:
                for sess in pending:
                    out[sess.key] = self._finish(sess,
                                                 self._solve_single(sess))
        return out

    # -- stats / lifecycle --------------------------------------------------
    def stats(self) -> dict:
        """Hit-rate / occupancy snapshot (the load harness reports these)."""
        return {
            "requests": self.requests_served,
            "reuse_hits": self.reuse_hits,
            "reuse_rate": (self.reuse_hits / self.requests_served
                           if self.requests_served else 0.0),
            "sessions_active": self.store.active,
            "evictions": self.store.evictions,
            "nbytes": self.store.nbytes,
        }

    def end_session(self, session: str) -> None:
        """Drop a session (frees its byte-budget share immediately)."""
        self.store.pop(session)

    # -- checkpoint / resume ------------------------------------------------
    # A session IS a StreamingCoreset, so kill-and-resume rides the
    # CheckpointManager round trip (either package's manager): the restored
    # session finalizes to the same core-set and certificate as an
    # uninterrupted one.

    def save_session(self, session: str, manager, step: int) -> None:
        """Checkpoint one session's core-set (constrained sessions are not
        checkpointable yet, matching the planner's resilience rule)."""
        sess = self.store.get(session)
        if sess is None:
            raise KeyError(f"no live session {session!r}")
        if self.matroid is not None:
            raise ValueError("checkpoint/resume is not yet supported for "
                             "constrained sessions")
        sess.coreset.save(manager, step)

    def restore_session(self, session: str, manager,
                        step: Optional[int] = None) -> bool:
        """Rebuild a session from its checkpoint on the reranker's device
        (replacing any live state).  Returns False when the manager holds
        no checkpoint."""
        from ..core.smm import StreamingCoreset

        smm, _ = StreamingCoreset.restore(manager, step, device=self.device,
                                          use_pallas=self.use_pallas)
        if smm is None:
            return False
        sess = Session(key=session, coreset=smm, nbytes=session_nbytes(smm))
        self.store.put(sess)
        _count("sessions_active")
        return True
