"""SMM / SMM-EXT / SMM-GEN — the paper's streaming core-set constructions
(§4, §6.1), port of ``repro.core.smm``.

The doubling algorithm of Charikar et al. as the paper adapts it:

* state is a set ``T`` of at most ``k'+1`` centers and a threshold ``d_i``;
* each phase starts with a *merge* — a maximal independent set of the graph
  with edges ``d(t1,t2) <= 2 d_i`` — and continues with an *update* that
  discards points with ``d(p,T) <= 4 d_i`` and inserts farther points until
  ``T`` holds ``k'+1`` points, whereupon ``d_{i+1} = 2 d_i``;
* the ``M`` buffer (the centers the last merge removed) tops ``T`` up to
  ``>= k`` points at stream end;
* SMM-EXT keeps up to ``k`` delegates per center (slot 0 = the center); a
  removed center's delegates go to its nearest kept center, up to ``k``; a
  discarded point joins its nearest center's delegates if there is room;
* SMM-GEN keeps only the counts — a generalized core-set.

How the reference's device loops become the port's:

* **Chunk filter.**  One ``(tail, k'+1)`` distance tile per chunk tail, through
  the B3 kernel (``kernels.ops.pairwise``) when the run resolved to it, a
  masked min/argmin (first index on ties), the first far position found on
  the device, and the near prefix absorbed by a sync-free scatter.  The host
  reads one int per tail, as the reference does.
* **Far points.**  The reference walks every point from the first far one
  to the chunk's end in an on-device ``while_loop``.  Here the tail's
  nearest-center field is kept and, after a far point is inserted into slot
  ``s``, only column ``s`` is computed (a one-row B3 call) and folded in;
  the next far position is the first later row beyond ``4 d_i``, and the
  near rows before it are absorbed against the current centers.  ``T``
  changes only at an insert or a merge, so the decisions equal the
  per-point algorithm's; the loop runs once per insert (one host read
  each), not once per point.  The B3 kernel sums every entry in one fixed
  order, so a column computed alone equals the same column of a full tile.
* **Merge.**  The greedy MIS and the delegate inheritance are two
  sequential loops over the slots.  The ``(cap, cap)`` distance matrix and
  the counts are read to the host once per merge, the plan (kept slots,
  delegate moves, the ``M`` buffer) is made in numpy, and the moves are
  applied on the device in one gather/scatter.  Merges happen once per
  phase, so one read each is cheap.

The host mirrors the validity mask and the threshold (``d_i`` only ever
doubles from its first value, which is read once at boot), so choosing a
free slot or noticing that ``T`` is full costs no device read.

The algorithmic counters (``points_absorbed``, ``merges``), ``n_phases``,
the phase log and ``generation`` equal the reference's for the same stream
and chunking.  ``device_dispatches`` (distance tiles computed),
``host_syncs`` (host reads) and ``far_inserts`` count the port's own work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_points, resolve_device, resolve_use_pallas, to_numpy
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs.trace import count as _count, span as _span
from .coreset import Coreset, GeneralizedCoreset
from .metrics import get_metric

INF = float("inf")
_NOT_PORTED_CKPT = ("checkpoint save/restore of a stream needs "
                    "CheckpointManager, which is not ported to repro_torch "
                    "yet (ROADMAP A, slice 12: resilience); state_dict() and "
                    "from_state_dict() carry the state in memory")


class SMMState(NamedTuple):
    T: torch.Tensor          # (cap, d) centers
    t_valid: torch.Tensor    # (cap,) bool
    e_pts: torch.Tensor      # (cap, k_slots, d) delegates (slot 0 = center)
    e_cnt: torch.Tensor      # (cap,) int32 delegates/multiplicity count
    M: torch.Tensor          # (cap, d) last-merge-removed buffer
    m_valid: torch.Tensor    # (cap,) bool
    d_thr: torch.Tensor      # () current d_i
    n_phases: torch.Tensor   # () int32


def _init_threshold(dm: np.ndarray) -> np.float32:
    """Smallest strictly positive off-diagonal distance (the eye mask hides
    the rounding-size self-distances of the factorized form; duplicates are
    excluded); a tiny epsilon if all points coincide."""
    off = dm.copy()
    np.fill_diagonal(off, np.inf)
    pos = off[off > 0]
    d1 = pos.min() if pos.size else np.float32(np.inf)
    return np.float32(d1) if np.isfinite(d1) else np.float32(1e-30)


def _merge_plan(dm, valid, e_cnt, thr, mode: str, k: int):
    """One merge step on the host, in the reference's slot order: the greedy
    MIS at threshold ``thr`` and (ext/gen) the delegate inheritance.
    Returns (keep, removed, e_cnt', moves) with moves as
    (removed slot, kept slot, first free delegate slot there, count)."""
    cap = valid.shape[0]
    keep = np.zeros(cap, bool)
    covered = np.zeros(cap, bool)
    for j in range(cap):
        if valid[j] and not covered[j]:
            keep[j] = True
            covered |= dm[j] <= thr
    removed = valid & ~keep
    e_cnt = e_cnt.copy()
    moves = []
    if mode == "plain":
        e_cnt[~keep] = 0
        return keep, removed, e_cnt, moves
    for j in np.flatnonzero(removed):
        t2 = int(np.argmin(np.where(keep, dm[j], np.inf)))
        take = max(min(int(e_cnt[j]), k - int(e_cnt[t2])), 0)
        if take:
            moves.append((int(j), t2, int(e_cnt[t2]), take))
        e_cnt[t2] += take
        e_cnt[j] = 0
    return keep, removed, e_cnt, moves


class StreamingCoreset:
    """The paper's one-pass streaming core-set (§4/§6.1) with ``O(k'·k)``
    state, on the run's device.

    ``mode="plain"`` keeps centers only (remote-edge/cycle, Thm 4);
    ``mode="ext"`` keeps up to k delegates per center (the clique-type
    measures, Thm 5); ``mode="gen"`` keeps multiplicities (generalized
    core-sets, Thm 9).  Feed chunks of any size — the state is
    chunk-invariant.  ``device`` defaults to ``"cuda"`` (a missing card
    raises); ``use_pallas="auto"`` runs the distance tiles through the B3
    kernel on a CUDA device and plain torch on the CPU.

    >>> import numpy as np
    >>> from repro_torch.core import StreamingCoreset, solve_on_coreset
    >>> rng = np.random.default_rng(0)
    >>> smm = StreamingCoreset(k=4, kprime=16, dim=3, device="cpu")
    >>> for _ in range(5):                  # any chunking works
    ...     smm.update(rng.normal(size=(200, 3)).astype(np.float32))
    >>> smm.n_seen
    1000
    >>> cs = smm.finalize()                 # composable Coreset
    >>> tuple(solve_on_coreset(cs, k=4, measure="remote-edge").shape)
    (4, 3)
    """

    def __init__(self, k: int, kprime: int, dim: int, *, metric="euclidean",
                 mode: str = "plain", dtype=torch.float32,
                 eps: Optional[float] = None, device=None,
                 use_pallas="auto"):
        if mode not in ("plain", "ext", "gen"):
            raise ValueError(mode)
        if kprime < k:
            raise ValueError("k' must be >= k")
        m = get_metric(metric)
        if not m.is_metric:
            raise ValueError(f"SMM needs a true metric, got {metric!r}")
        self.k, self.kprime, self.dim = k, kprime, dim
        self.metric, self.mode, self.dtype = m.name, mode, dtype
        self.eps = eps           # accuracy target recorded in the certificate
        self.cap = kprime + 1
        self.device = resolve_device(device)
        self.use_pallas = resolve_use_pallas(use_pallas, self.device, m.name)
        self._kernel_metric = m.name in ("euclidean", "cosine")
        self._k_slots = k if mode == "ext" else 1
        self._prefix = []        # buffers the first cap points (tensors)
        self._booted = False
        self.n_seen = 0
        self._n_processed = 0
        # cache-invalidation token, bumped exactly as the reference bumps
        # it: boot, pre-boot buffering, every tail that meets a far point,
        # and (ext/gen) any update whose points were all absorbed
        self.generation = 0
        # per-merge re-certification log: (n_processed, d_i) at every merge
        self._phase_log = []

    # -- distances ------------------------------------------------------------
    def _prep(self, x):
        """Rows in the form the distance tile reads (normalized for cosine)
        and their squared norms (euclidean), computed once per chunk."""
        if self._kernel_metric:
            return kops.prepare(x, self.metric)
        return kops.Prepared(x, None)

    def _dist(self, xp, xsq, yp, ysq):
        """(rows of xp, rows of yp) distance tile: the B3 kernel when the
        run resolved to it, else the plain version."""
        _count("device_dispatches")
        if self.use_pallas:
            return kops.pairwise(xp, yp, self.metric, xsq=xsq, ysq=ysq,
                                 prepared=True)
        if self._kernel_metric:
            return kref.pairwise_ref(xp, yp, self.metric, xsq=xsq, ysq=ysq)
        return get_metric(self.metric).pairwise(xp, yp)

    def _center_tile(self):
        sq = self._tsq
        return self._dist(self._Tp, sq, self._Tp, sq)

    def _set_centers(self, T) -> None:
        """Adopt ``T`` (cap, d) as the centers, with their kernel-form rows
        (the same tensor unless cosine normalizes) and squared norms."""
        self._T = T
        prep = self._prep(T)
        self._Tp = T if prep.points is T else prep.points
        self._tsq = prep.xsq

    # -- init -------------------------------------------------------------
    def _boot(self, pts0):
        self._n_processed = self.cap
        cap, dim, dev = self.cap, self.dim, self.device
        self._set_centers(pts0.clone())
        self._valid = torch.ones((cap,), dtype=torch.bool, device=dev)
        self._valid_np = np.ones(cap, bool)
        # delegate rows, flat (cap * k_slots, d), plus one sink row that
        # takes the writes of rejected points (the scatter stays sync-free)
        self._e_flat = torch.zeros((cap * self._k_slots + 1, dim),
                                   dtype=self.dtype, device=dev)
        if self.mode == "ext":
            self._e_flat[:cap * self._k_slots:self._k_slots] = self._T
        self._e_cnt = torch.ones((cap,), dtype=torch.int32, device=dev)
        self._M = torch.zeros((cap, dim), dtype=self.dtype, device=dev)
        self._m_valid_np = np.zeros(cap, bool)
        self._n_phases = 0
        dm = to_numpy(self._center_tile())
        _count("host_syncs")
        self._d_thr = _init_threshold(dm)
        self._booted = True
        _count("points_absorbed", cap)       # the boot prefix
        self.generation += 1
        # T is full after initialization -> Phase 1 begins with a merge
        self._merge_until_room(dm)

    def _merge_until_room(self, dm: Optional[np.ndarray] = None) -> None:
        """Merge at 2·d_i; while the MIS removed nothing (every pairwise
        distance > 2 d_i) double d_i and merge again — on the host, over the
        one matrix read."""
        with _span("smm.merge", n_processed=self._n_processed):
            if dm is None:
                dm = to_numpy(self._center_tile())
                _count("host_syncs")
            e_cnt = to_numpy(self._e_cnt).astype(np.int64)
            _count("host_syncs")
            valid = self._valid_np
            while True:
                keep, removed, e_cnt, moves = _merge_plan(
                    dm, valid, e_cnt, np.float32(2.0) * self._d_thr,
                    self.mode, self.k)
                self._n_phases += 1
                valid = keep
                if keep.sum() < self.cap:
                    break
                self._d_thr = np.float32(self._d_thr * np.float32(2.0))
            self._apply_merge(keep, removed, e_cnt, moves)
            _count("merges")
            # stamp with the exact number of stream points processed when
            # the merge fired, which keeps the log chunk-invariant
            self._phase_log.append((self._n_processed, float(self._d_thr)))

    def _apply_merge(self, keep, removed, e_cnt, moves) -> None:
        dev = self.device
        self._valid_np = keep
        self._m_valid_np = removed
        self._valid = torch.as_tensor(keep, device=dev)
        rem = torch.as_tensor(removed, device=dev)
        self._M = torch.where(rem[:, None], self._T,
                              torch.zeros((), dtype=self.dtype, device=dev))
        self._e_cnt = torch.as_tensor(e_cnt.astype(np.int32), device=dev)
        if moves and self.mode == "ext":
            ks = self._k_slots
            src = np.concatenate([j * ks + np.arange(t)
                                  for j, _, _, t in moves])
            dst = np.concatenate([t2 * ks + s + np.arange(t)
                                  for _, t2, s, t in moves])
            src = torch.as_tensor(src, device=dev)
            dst = torch.as_tensor(dst, device=dev)
            # sources are removed slots, destinations kept ones: disjoint
            self._e_flat.index_copy_(0, dst, self._e_flat.index_select(0, src))

    # -- streaming ----------------------------------------------------------
    def update(self, chunk) -> None:
        chunk = as_points(chunk, self.device, self.dtype)
        if chunk.ndim < 2:
            chunk = chunk.reshape(1, -1)
        if chunk.shape[0] == 0:
            return
        self.n_seen += chunk.shape[0]
        gen0 = self.generation
        if not self._booted:
            need = self.cap - sum(len(p) for p in self._prefix)
            self._prefix.append(chunk[:need])
            chunk = chunk[need:]
            if sum(len(p) for p in self._prefix) >= self.cap:
                self._boot(torch.cat(self._prefix, dim=0))
                self._prefix = []
            else:
                # still buffering: finalize() would return the grown prefix
                self.generation += 1
            if chunk.shape[0] == 0:
                return
        self._consume(chunk, self.n_seen - chunk.shape[0])
        if self.mode != "plain" and self.generation == gen0:
            # ext/gen: even fully-absorbed points mutate delegate sets /
            # multiplicities, so the finalized core-set may change
            self.generation += 1

    def _consume(self, chunk, base: int = 0) -> None:
        """The chunk loop: one distance tile per tail, one host read per
        tail and per far insert.  ``base`` is the number of stream points
        processed before this chunk (phase-log stamps only)."""
        c = chunk.shape[0]
        prep = self._prep(chunk)
        pos = 0
        while pos < c:
            x = prep.points[pos:]
            xsq = None if prep.xsq is None else prep.xsq[pos:]
            tail = chunk[pos:]
            dm = self._dist(x, xsq, self._Tp, self._tsq)      # (ct, cap)
            dm.masked_fill_(~self._valid[None, :], INF)
            near_d, nearest = torch.min(dm, dim=1)            # first index
            del dm
            ct = tail.shape[0]
            rows = torch.arange(ct, device=self.device)
            far = near_d > self._far_thr()
            first_far = torch.where(far, rows, ct).min()
            self._absorb(tail, nearest, 0, first_far)
            first = int(first_far)                 # the one read per tail
            _count("host_syncs")
            if first == ct:                         # whole tail absorbed
                break
            self.generation += 1                    # far insert mutates T
            consumed, full = self._insert_far(tail, x, xsq, near_d, nearest,
                                              first)
            pos += consumed
            if full:
                self._d_thr = np.float32(self._d_thr * np.float32(2.0))
                self._n_processed = base + pos
                self._merge_until_room()
        _count("points_absorbed", c)

    def _far_thr(self) -> float:
        # 4·d_i in float32 (exact: a power-of-two scaling), as a Python
        # float that compares exactly against the float32 field
        return float(np.float32(4.0) * self._d_thr)

    def _insert_far(self, tail, x, xsq, near_d, nearest, r: int):
        """Insert the far point at tail row ``r`` and every later far point
        until the tail ends or ``T`` fills.  Returns (rows consumed, full)."""
        ct = tail.shape[0]
        thr = self._far_thr()
        while True:
            s = int(np.argmin(self._valid_np))      # first free slot
            _count("far_inserts")
            self._T[s] = tail[r]
            if self._Tp is not self._T:
                self._Tp[s] = x[r]
            if self._tsq is not None:
                self._tsq[s] = xsq[r]
            self._valid[s] = True
            self._valid_np[s] = True
            if self.mode != "plain":
                self._e_cnt[s] = 1
                if self.mode == "ext":
                    self._e_flat[s * self._k_slots] = tail[r]
            if self._valid_np.all():
                return r + 1, True
            lo = r + 1
            if lo == ct:
                return ct, False
            # fold the new center's column into the rows after r
            col = self._dist(x[lo:], None if xsq is None else xsq[lo:],
                             self._Tp[s:s + 1],
                             None if self._tsq is None
                             else self._tsq[s:s + 1])[:, 0]
            nd, nn = near_d[lo:], nearest[lo:]
            better = (col < nd) | ((col == nd) & (nn > s))   # first index
            nd.copy_(torch.where(better, col, nd))
            nn.copy_(torch.where(better, s, nn))
            rows = torch.arange(lo, ct, device=self.device)
            next_far = torch.where(nd > thr, rows, ct).min()
            self._absorb(tail, nearest, lo, next_far)
            r = int(next_far)                     # one read per far insert
            _count("host_syncs")
            if r == ct:
                return ct, False

    def _absorb(self, tail, nearest, lo: int, hi) -> None:
        """Commit the delegate/count updates of the near rows ``lo <= i <
        hi`` of ``tail`` (``hi`` may be a device scalar: nothing is read).

        Capacity-respecting and order-preserving: the r-th near row routed
        to a center lands in slot e_cnt + r, provided that is < k.  A stable
        argsort of the center index, ``searchsorted`` for the group starts,
        an ``index_add_`` for the counts and (ext) one ``index_copy_`` whose
        rejected rows all land on a sink row."""
        if self.mode == "plain":
            return                                  # discards only
        cap, k, dev = self.cap, self.k, self.device
        ct = tail.shape[0]
        rows = torch.arange(ct, device=dev)
        near = (rows >= lo) & (rows < hi)
        nst = torch.where(near, nearest, cap)       # sentinel group = cap
        order = torch.argsort(nst, stable=True)
        snst = nst[order]
        starts = torch.searchsorted(snst, torch.arange(cap + 1, device=dev))
        rank = torch.empty_like(rows)
        rank[order] = rows - starts[snst]
        slot = self._e_cnt[nst.clamp(max=cap - 1)].long() + rank
        accept = near & (slot < k)
        group = torch.where(accept, nst, cap)
        adds = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
        adds.index_add_(0, group, accept.long())
        self._e_cnt = torch.clamp(self._e_cnt + adds[:cap], max=k).to(
            torch.int32)
        if self.mode == "ext":
            ks = self._k_slots
            dst = torch.where(accept, nst * ks + slot, cap * ks)
            self._e_flat.index_copy_(0, dst, tail)

    # -- certification ------------------------------------------------------
    def certificate(self):
        """Streaming ``RadiusCertificate``: the proxy-distance bound 4·d_i
        against the anticover scale measured on the live centers (exact GMM
        over the <= k'+1 centers, through the port's ``core.gmm.gmm``).  The
        trajectory is the per-merge phase log (n_processed, 4·d_i)."""
        from .adaptive import RadiusCertificate, _ratio
        from .gmm import gmm as _gmm

        counts = tuple(n for n, _ in self._phase_log)
        radii = tuple(4.0 * d for _, d in self._phase_log)
        if not self._booted:
            return RadiusCertificate(
                kprime=self.kprime, radius=0.0, scale=0.0, ratio=0.0,
                eps_target=self.eps,
                meets_target=None if self.eps is None else True,
                counts=counts, radii=radii, kind="streaming")
        radius = 4.0 * float(self._d_thr)
        if int(self._valid_np.sum()) >= self.k:
            res = _gmm(self._T, self.k, metric=self.metric, mask=self._valid,
                       start=int(np.argmax(self._valid_np)),
                       use_pallas=self.use_pallas)
            scale = float(res.radius)
        else:
            scale = 0.0
        ratio = _ratio(radius, scale)
        return RadiusCertificate(
            kprime=self.kprime, radius=radius, scale=scale, ratio=ratio,
            eps_target=self.eps,
            meets_target=None if self.eps is None else bool(ratio <= self.eps),
            counts=counts, radii=radii, kind="streaming")

    # -- output -------------------------------------------------------------
    def finalize(self, *, allow_small: bool = False):
        """The core-set of the stream so far, carrying the streaming
        ``RadiusCertificate`` as ``.cert`` (tensors are copies: the stream
        can go on).  ``allow_small=True`` returns whatever the stream held
        when it had fewer than ``k`` points."""
        dev = self.device
        if not self._booted:
            # tiny stream: everything fits in the prefix buffer
            pts = (torch.cat(self._prefix, dim=0) if self._prefix else
                   torch.zeros((0, self.dim), dtype=self.dtype, device=dev))
            if pts.shape[0] < self.k and not allow_small:
                raise ValueError(
                    f"stream had {pts.shape[0]} < k={self.k} points")
            n = pts.shape[0]
            return Coreset(points=pts,
                           valid=torch.ones((n,), dtype=torch.bool,
                                            device=dev),
                           weights=torch.ones((n,), dtype=torch.int32,
                                              device=dev),
                           radius=torch.zeros((), device=dev),
                           cert=self.certificate())
        cert = self.certificate()
        T, valid = self._T.clone(), self._valid.clone()
        e_cnt, e_flat = self._e_cnt.clone(), self._e_flat.clone()
        if int(self._valid_np.sum()) < self.k:
            self._topup_from_M(T, valid, e_cnt, e_flat)
        radius = torch.tensor(4.0, device=dev) * float(self._d_thr)
        if self.mode == "plain":
            return Coreset(points=T, valid=valid,
                           weights=valid.to(torch.int32), radius=radius,
                           cert=cert)
        if self.mode == "gen":
            mult = torch.where(valid, torch.clamp(e_cnt, min=1), 0)
            return GeneralizedCoreset(points=T,
                                      multiplicity=mult.to(torch.int32),
                                      radius=radius, cert=cert)
        # ext: union of delegate sets
        cap, ks = self.cap, self._k_slots
        pts = e_flat[:cap * ks]
        slot = torch.arange(ks, device=dev).repeat(cap)
        row = torch.arange(cap, device=dev).repeat_interleave(ks)
        ok = valid[row] & (slot < e_cnt[row])
        return Coreset(points=pts, valid=ok, weights=ok.to(torch.int32),
                       radius=radius, cert=cert)

    def _topup_from_M(self, T, valid, e_cnt, e_flat) -> None:
        """Top ``T`` up to k centers from the ``M`` buffer, in slot order
        (the paper's fix: M ∪ I has >= k'+1 >= k points).  Planned on the
        host mirror; writes the given copies."""
        v = self._valid_np.copy()
        ks = self._k_slots
        for j in np.flatnonzero(self._m_valid_np):
            if v.sum() >= self.k:
                break
            free = int(np.argmin(v))
            v[free] = True
            T[free] = self._M[j]
            valid[free] = True
            e_cnt[free] = 1
            e_flat[free * ks] = self._M[j]

    @property
    def state(self) -> Optional[SMMState]:
        """The SMM state as tensors on the run's device (None before
        boot)."""
        if not self._booted:
            return None
        cap, ks, dim, dev = self.cap, self._k_slots, self.dim, self.device
        return SMMState(
            T=self._T, t_valid=self._valid,
            e_pts=self._e_flat[:cap * ks].view(cap, ks, dim),
            e_cnt=self._e_cnt, M=self._M,
            m_valid=torch.as_tensor(self._m_valid_np, device=dev),
            d_thr=torch.tensor(float(self._d_thr), dtype=self.dtype,
                               device=dev),
            n_phases=torch.tensor(self._n_phases, dtype=torch.int32,
                                  device=dev))

    @property
    def phase_log(self):
        """Per-merge (n_processed, d_i) re-certification log (read-only)."""
        return tuple(self._phase_log)

    # -- checkpoint / resume -------------------------------------------------
    # Everything a resumed run needs is the SMMState plus a handful of host
    # scalars (n_seen, the phase log, the pre-boot prefix); the layout is
    # the reference's, so ``interop`` carries a stream across.

    def _zero_state(self) -> SMMState:
        cap, dim, ks, dev = self.cap, self.dim, self._k_slots, self.device
        z = torch.zeros((cap, dim), dtype=self.dtype, device=dev)
        return SMMState(
            T=z, t_valid=torch.zeros((cap,), dtype=torch.bool, device=dev),
            e_pts=torch.zeros((cap, ks, dim), dtype=self.dtype, device=dev),
            e_cnt=torch.zeros((cap,), dtype=torch.int32, device=dev),
            M=z.clone(), m_valid=torch.zeros((cap,), dtype=torch.bool,
                                             device=dev),
            d_thr=torch.zeros((), dtype=self.dtype, device=dev),
            n_phases=torch.zeros((), dtype=torch.int32, device=dev))

    def state_dict(self):
        """``(arrays, meta)`` snapshot of the entire streaming progress in
        the reference's layout: ``arrays`` is a flat dict of tensors (the
        SMMState fields plus the pre-boot prefix buffer), ``meta`` the host
        scalars and the phase log (JSON-serializable)."""
        prefix = (torch.cat(self._prefix, dim=0) if self._prefix else
                  torch.zeros((0, self.dim), dtype=self.dtype,
                              device=self.device))
        st = self.state if self._booted else self._zero_state()
        arrays = {"prefix": prefix, **st._asdict()}
        meta = {"k": self.k, "kprime": self.kprime, "dim": self.dim,
                "metric": self.metric, "mode": self.mode, "eps": self.eps,
                "dtype": str(self.dtype).replace("torch.", ""),
                "n_seen": int(self.n_seen),
                "n_prefix": int(prefix.shape[0]),
                "n_processed": int(self._n_processed),
                "generation": int(self.generation),
                "booted": self._booted,
                "phase_log": [[int(n), float(d)] for n, d in self._phase_log]}
        return arrays, meta

    @classmethod
    def from_state_dict(cls, arrays, meta, *, device=None,
                        use_pallas="auto") -> "StreamingCoreset":
        """Rebuild a stream from ``state_dict()`` output — the port's, or the
        reference's with its arrays read as numpy arrays."""
        smm = cls(int(meta["k"]), int(meta["kprime"]), int(meta["dim"]),
                  metric=meta["metric"], mode=meta["mode"],
                  dtype=getattr(torch, meta["dtype"]), eps=meta["eps"],
                  device=device, use_pallas=use_pallas)
        dev, dt = smm.device, smm.dtype

        def t(name, dtype):
            return torch.as_tensor(np.array(to_numpy(arrays[name])),
                                   dtype=dtype, device=dev)

        smm.n_seen = int(meta["n_seen"])
        smm.generation = int(meta.get("generation", 0))
        smm._phase_log = [(int(n), float(d)) for n, d in meta["phase_log"]]
        n_prefix = int(meta["n_prefix"])
        if n_prefix:
            smm._prefix = [t("prefix", dt)[:n_prefix]]
        if meta["booted"]:
            cap, ks = smm.cap, smm._k_slots
            smm._n_processed = int(meta["n_processed"])
            smm._set_centers(t("T", dt).contiguous())
            smm._valid_np = np.array(to_numpy(arrays["t_valid"]), bool)
            smm._valid = torch.as_tensor(smm._valid_np, device=dev)
            smm._e_flat = torch.zeros((cap * ks + 1, smm.dim), dtype=dt,
                                      device=dev)
            smm._e_flat[:cap * ks] = t("e_pts", dt).reshape(cap * ks, -1)
            smm._e_cnt = t("e_cnt", torch.int32)
            smm._M = t("M", dt)
            smm._m_valid_np = np.array(to_numpy(arrays["m_valid"]), bool)
            smm._d_thr = np.float32(to_numpy(arrays["d_thr"]))
            smm._n_phases = int(to_numpy(arrays["n_phases"]))
            smm._booted = True
        return smm

    def save(self, manager, step: int) -> None:
        raise NotImplementedError(_NOT_PORTED_CKPT)

    @classmethod
    def restore(cls, manager, step: Optional[int] = None):
        raise NotImplementedError(_NOT_PORTED_CKPT)
