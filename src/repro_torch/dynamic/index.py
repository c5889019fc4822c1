"""The fully dynamic diversity index (``mode="dynamic"``; port of
``repro.dynamic.index``).

``DynamicIndex`` keeps a churning point set queryable: ``insert(points)``
and ``delete(ids)`` maintain the leveled cover structure of
``dynamic.levels`` incrementally on the index's device, ``query(k)``
solves on the finest affordable level's centers — the *level-induced
core-set* — with the m = 1 schedule engine (``core.gmm.gmm_schedule``, one
B1 sweep a pick on the card) and returns a certified result.  The
``RadiusCertificate`` it mints carries the level's measured cover radius
as the proxy bound, the engine's anticover scale at ``k``, and the churn
accounting (``updates_since_rebuild`` / ``deletions_absorbed``).

The point store, the liveness mask and the level arrays are tensors on
``device`` (the card by default; a missing card raises) in buffers whose
capacity doubles.  Every maintenance distance is one tile of the B3
kernel (``kernels.ops.pairwise``) over rows whose sweep invariants
(cosine's normalized rows, euclidean's squared norms) are computed once
when they are inserted; ``use_pallas=False`` or a CPU index runs the
kernel's plain version (``kernels.ref.pairwise_ref``), and manhattan,
which has no kernel mode, runs plain torch everywhere.

Every piece of state is deterministic given the update sequence, so
``state_dict()``/``save()``/``restore()`` give a *bit-identical* resume
point, in the reference's checkpoint layout: a checkpoint written by
either package restores in the other.

>>> import numpy as np
>>> from repro_torch.dynamic import DynamicIndex
>>> rng = np.random.default_rng(0)
>>> idx = DynamicIndex(dim=4, device="cpu")
>>> ids = idx.insert(rng.normal(size=(200, 4)).astype(np.float32))
>>> idx.delete(ids[:50])
>>> q = idx.query(4)
>>> tuple(q.solution.shape)
(4, 4)
>>> q.cert.kind
'dynamic'
>>> q.cert.deletions_absorbed
50
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import as_points, resolve_device, resolve_use_pallas, to_numpy
from ..obs.trace import count as _count
from .levels import LevelStructure, Rows, take
from .ops import Delete, Insert
from .rebuild import RebuildPolicy

_KERNEL_METRICS = ("euclidean", "cosine")


@dataclasses.dataclass(frozen=True)
class DynamicQueryResult:
    """One certified answer off the live index.

    ``solution`` is the ``(k, d)`` picks (a tensor on the index's device),
    ``ids`` their stable point ids (the handles ``insert`` returned, host
    int64), ``coreset`` the level-induced ``core.coreset.Coreset`` the
    engine solved on, ``cert`` its ``RadiusCertificate`` (kind="dynamic")
    and ``level`` the query level (None when the index fell back to
    solving on the live points).
    """
    solution: torch.Tensor
    ids: np.ndarray
    coreset: Any
    cert: Any
    level: Optional[int]


class DynamicIndex:
    """A leveled cover over a live point set with certified queries.

    ``budget`` is the query core-set target (the planner passes the
    resolved ``kprime``); levels that outgrow ``max(4 x budget, 256)``
    centers are frozen until the next rebuild (see ``dynamic.levels``).
    ``policy`` (a ``RebuildPolicy``) decides when incremental repair gives
    way to a from-scratch rebuild.  ``device`` holds the index (default
    the card); ``use_pallas="auto"`` runs the B3 kernel there.
    """

    def __init__(self, dim: Optional[int] = None, *,
                 metric: str = "euclidean",
                 policy: Optional[RebuildPolicy] = None,
                 budget: int = 256, device=None,
                 use_pallas="auto") -> None:
        from ..core.metrics import get_metric

        m = get_metric(metric)
        if not m.is_metric:
            raise ValueError(
                f"metric {m.name!r} violates the triangle inequality; the "
                "dynamic cover structure needs a true metric")
        self.metric = m.name
        self.device = resolve_device(device)
        self.use_pallas = resolve_use_pallas(use_pallas, self.device, m.name)
        self.dim = None if dim is None else int(dim)
        self.policy = policy or RebuildPolicy()
        self.budget = int(budget)
        self._n = 0
        self._n_alive = 0
        self._alloc(0, self.dim or 0)
        self._levels: Optional[LevelStructure] = None
        self.inserts_total = 0
        self.deletes_total = 0
        self.updates_since_rebuild = 0
        self.deletions_absorbed = 0
        self.rebuilds = 0
        self._phase_log: List[Tuple[str, float]] = []
        self._syncs = 0

    # -- storage -------------------------------------------------------------
    def _alloc(self, cap: int, d: int) -> None:
        dev = self.device
        self._pts_buf = torch.zeros((cap, d), dtype=torch.float32, device=dev)
        self._alive_buf = torch.zeros((cap,), dtype=torch.bool, device=dev)
        # the rows as the distance oracle reads them: normalized for
        # cosine (else the points themselves) and squared norms for
        # euclidean, computed once per inserted row
        self._rows_buf = (torch.zeros_like(self._pts_buf)
                          if self.metric == "cosine" else self._pts_buf)
        self._sq_buf = (torch.zeros((cap,), dtype=torch.float32, device=dev)
                        if self.metric == "euclidean" else None)

    def _grow(self, n: int) -> None:
        cap = self._pts_buf.shape[0]
        if n <= cap:
            return
        old = (self._pts_buf, self._alive_buf, self._rows_buf, self._sq_buf)
        self._alloc(max(n, 2 * cap), self.dim)
        k = self._n
        self._pts_buf[:k] = old[0][:k]
        self._alive_buf[:k] = old[1][:k]
        if self.metric == "cosine":
            self._rows_buf[:k] = old[2][:k]
        if self._sq_buf is not None:
            self._sq_buf[:k] = old[3][:k]

    def _write_rows(self, start: int, pts: torch.Tensor) -> None:
        end = start + pts.shape[0]
        self._pts_buf[start:end] = pts
        self._alive_buf[start:end] = True
        if self.metric in _KERNEL_METRICS:
            from ..kernels.ops import prepare
            prep = prepare(pts, self.metric)
            if self.metric == "cosine":
                self._rows_buf[start:end] = prep.points
            else:
                self._sq_buf[start:end] = prep.xsq

    @property
    def _pts(self) -> torch.Tensor:
        return self._pts_buf[:self._n]

    @property
    def _alive(self) -> torch.Tensor:
        return self._alive_buf[:self._n]

    # -- introspection -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        """Rows ever inserted (= the next id)."""
        return self._n

    @property
    def n_alive(self) -> int:
        return self._n_alive

    @property
    def booted(self) -> bool:
        return self._levels is not None

    @property
    def phase_log(self) -> Tuple[Tuple[str, float], ...]:
        """(event, stamp) re-certification log: boot/rebuild events with the
        live count at that point (read-only copy)."""
        return tuple(self._phase_log)

    @property
    def host_syncs(self) -> int:
        """Reads of device values made by the maintenance and the query's
        level selection so far (the engine's own reads not included)."""
        return self._syncs + (0 if self._levels is None
                              else self._levels.host_syncs)

    def _rows(self, ids: torch.Tensor) -> Rows:
        return take(Rows(self._rows_buf, self._sq_buf), ids)

    def _dist(self, a: Rows, b: Rows) -> torch.Tensor:
        """The (m, n) metric distance tile between two row sets: the B3
        kernel on the card (``use_pallas``), its plain version otherwise;
        manhattan (no kernel mode) through plain torch."""
        if self.metric not in _KERNEL_METRICS:
            from ..core.metrics import get_metric
            return get_metric(self.metric).pairwise(a.points, b.points)
        from ..kernels import ops as kops
        if self.use_pallas:
            return kops.pairwise(a.points, b.points, self.metric, xsq=a.sq,
                                 ysq=b.sq, prepared=True)
        return kops.ref.pairwise_ref(a.points, b.points, self.metric,
                                     xsq=a.sq, ysq=b.sq)

    def _pair(self, a_ids, b_ids) -> torch.Tensor:
        """Metric distances between two id sets of the point store."""
        return self._dist(self._rows(a_ids), self._rows(b_ids))

    def _new_levels(self, radii) -> LevelStructure:
        return LevelStructure(radii, self._rows, self._dist,
                              max_centers=max(4 * self.budget, 256),
                              device=self.device)

    # -- updates -------------------------------------------------------------
    def insert(self, points) -> np.ndarray:
        """Insert a ``(b, d)`` batch; returns the assigned stable ids."""
        pts = as_points(points, self.device)
        if pts.ndim < 2:
            pts = pts.reshape(1, -1)
        if self.dim is None:
            self.dim = int(pts.shape[1])
            self._alloc(0, self.dim)
        if pts.shape[1] != self.dim:
            raise ValueError(f"insert batch has dim {pts.shape[1]}, "
                             f"index holds dim {self.dim}")
        start, b = self._n, int(pts.shape[0])
        self._grow(start + b)
        self._write_rows(start, pts)
        self._n += b
        self._n_alive += b
        ids = np.arange(start, start + b, dtype=np.int64)
        if self._levels is not None:
            self._levels.ensure_rows(self._n)
            self._levels.insert(torch.arange(start, start + b,
                                             device=self.device), self._alive)
        elif self._n_alive >= 2:
            self._boot()
        self.inserts_total += b
        self.updates_since_rebuild += b
        _count("inserts_absorbed", b)
        self._maybe_rebuild()
        return ids

    def delete(self, ids) -> None:
        """Tombstone previously inserted points by id; repairs every active
        level (deleted centers hand their orphans to survivors or promote
        them) and re-certifies only the dirtied levels lazily."""
        ids = torch.unique(torch.as_tensor(
            ids if isinstance(ids, torch.Tensor) else np.asarray(ids),
            device=self.device).to(torch.int64).reshape(-1))
        if ids.numel() == 0:
            return
        self._syncs += 1
        lo, hi = (int(v) for v in torch.stack([ids.min(), ids.max()]).cpu())
        if lo < 0 or hi >= self._n:
            raise ValueError(f"delete: unknown id {lo}...{hi} (index holds "
                             f"{self._n} rows)")
        was = self._alive_buf[ids]
        self._syncs += 1
        if not bool(was.all()):
            gone = ids[~was]
            raise ValueError(f"delete: id {int(gone[0])} is already deleted")
        self._alive_buf[ids] = False
        self._n_alive -= int(ids.numel())
        if self._levels is not None:
            self._levels.delete(ids, self._alive)
        self.deletes_total += ids.numel()
        self.deletions_absorbed += ids.numel()
        self.updates_since_rebuild += ids.numel()
        _count("deletes_absorbed", ids.numel())
        self._maybe_rebuild()

    def apply(self, op: Union[Insert, Delete, tuple]) -> None:
        """Apply one update-stream op (the facade's per-unit entry point)."""
        from .ops import _as_op

        norm = _as_op(op)
        if norm is None:
            raise ValueError(f"not an update op: {type(op).__name__}")
        if isinstance(norm, Insert):
            self.insert(norm.points)
        else:
            self.delete(norm.ids)

    # -- rebuild scheduling --------------------------------------------------
    def _boot(self) -> None:
        """First build: fix the level radii off the boot set's diameter
        (level 0 spans it; each level halves) and greedy-build the levels.
        Later inserts beyond the boot diameter simply become extra level-0
        centers."""
        self._syncs += 1
        ids = torch.nonzero(self._alive).flatten()
        # 2x the eccentricity of the first point upper-bounds the diameter
        # (triangle inequality) in one O(n) tile — no n^2 boot matrix
        self._syncs += 1
        d_top = 2.0 * float(self._pair(ids[:1], ids).max())
        if d_top <= 0.0:
            d_top = 1.0                      # all-identical boot set
        radii = d_top / np.power(2.0, np.arange(self.policy.levels))
        self._levels = self._new_levels(radii)
        self._levels.ensure_rows(self._n)
        self._levels.rebuild(self._alive)
        self.rebuilds += 1
        self._phase_log.append(("boot", float(self._n_alive)))

    def _maybe_rebuild(self) -> None:
        if self._levels is None:
            return
        if not self.policy.should_rebuild(
                updates_since_rebuild=self.updates_since_rebuild,
                deletions_absorbed=self.deletions_absorbed,
                n_alive=self._n_alive):
            return
        self._levels.ensure_rows(self._n)
        self._levels.rebuild(self._alive)
        self.rebuilds += 1
        self.updates_since_rebuild = 0
        self.deletions_absorbed = 0
        self._phase_log.append(("rebuild", float(self._n_alive)))

    # -- query ---------------------------------------------------------------
    def query(self, k: int, *, budget: Optional[int] = None,
              measure: str = "remote-edge", eps: Optional[float] = None,
              chunk: int = 0, use_pallas=None) -> DynamicQueryResult:
        """Solve diversity maximization over the live points.

        Selects the finest level whose live center count fits ``budget``
        (default: the index budget, clamped to it), runs the m=1 schedule
        engine over those centers (B1 at p = 1 on the card; ``use_pallas``
        defaults to the index's) and certifies: ``radius`` is the level's
        measured cover radius (every live point is within it of the
        core-set), ``scale`` the engine's anticover radius at ``k``.
        """
        from ..core.adaptive import RadiusCertificate, _ratio
        from ..core.coreset import Coreset
        from ..core.gmm import gmm_schedule
        from ..core.sequential import solve

        n_alive = self._n_alive
        if n_alive < k:
            raise ValueError(f"index holds {n_alive} live points < k={k}")
        budget = self.budget if budget is None else min(int(budget),
                                                        self.budget)
        lev = (None if self._levels is None
               else self._levels.select_level(budget, k, self._alive))
        counts: Tuple[int, ...] = ()
        radii: Tuple[float, ...] = ()
        if lev is None:
            # un-booted or no affordable level: the live points themselves
            self._syncs += 1
            ids = torch.nonzero(self._alive).flatten()
            cover = 0.0
        else:
            lv = self._levels
            ids = lv.centers_of(lev, self._alive)
            # the coarse->query trail re-certifies exactly the dirty levels
            counts = tuple(int(c) for c in
                           lv.center_counts(self._alive)[:lev + 1])
            radii = tuple(lv.cover_radius(j, self._alive)
                          for j in range(lev + 1))
            cover = radii[-1]
        core = self._pts_buf.index_select(0, ids)
        # pad the core-set to the reference's fixed bucket (masked rows are
        # never selectable): the picks do not depend on it, and the engine's
        # work counters then equal the reference's
        n_core = int(ids.numel())
        cap = (self._levels.max_centers if self._levels is not None
               else max(4 * self.budget, 256))
        n_pad = max(cap, 1 << max(0, n_core - 1).bit_length())
        core_p = torch.zeros((n_pad, core.shape[1]), dtype=torch.float32,
                             device=self.device)
        core_p[:n_core] = core
        up = self.use_pallas if use_pallas is None else resolve_use_pallas(
            use_pallas, self.device, self.metric)
        res = gmm_schedule(core_p, k, ((1, k),), metric=self.metric,
                           mask=torch.arange(n_pad, device=self.device)
                           < n_core, chunk=chunk, use_pallas=up)
        scale = float(res.radius)
        ratio = _ratio(cover, scale)
        cert = RadiusCertificate(
            kprime=n_core, radius=float(cover), scale=scale,
            ratio=ratio, eps_target=eps,
            meets_target=None if eps is None else bool(ratio <= eps),
            counts=counts, radii=radii, b_schedule=((1, k),),
            kind="dynamic",
            updates_since_rebuild=self.updates_since_rebuild,
            deletions_absorbed=self.deletions_absorbed)
        dev = self.device
        cs = Coreset(points=core,
                     valid=torch.ones((n_core,), dtype=torch.bool,
                                      device=dev),
                     weights=torch.ones((n_core,), dtype=torch.int32,
                                        device=dev),
                     radius=torch.tensor(np.float32(cover), device=dev),
                     cert=cert)
        if measure == "remote-clique":
            # injective-matching measure: the engine prefix is not the
            # solver — run the α-approx sequential matching on the core-set
            pick = torch.as_tensor(solve(measure, core, k,
                                         metric=self.metric), device=dev)
        else:
            pick = res.idx[:k]
        return DynamicQueryResult(solution=core.index_select(0, pick),
                                  ids=to_numpy(ids.index_select(0, pick)),
                                  coreset=cs, cert=cert, level=lev)

    # -- checkpoint / resume -------------------------------------------------
    # Maintenance is deterministic in the update sequence, so serializing
    # the point store + level arrays + churn counters gives a bit-identical
    # resume point, in the reference's layout (keys, dtypes, meta).

    def state_dict(self):
        """``(arrays, meta)`` snapshot of the entire index, the reference's:
        ``arrays`` a flat dict of host numpy arrays (the point store and
        the level arrays sliced to ``n_rows``), ``meta`` the host scalars
        and the phase log (JSON-able)."""
        booted = self._levels is not None
        L = self.policy.levels
        lv = self._levels
        n = self._n
        arrays = {
            "points": to_numpy(self._pts).astype(np.float32, copy=False),
            "alive": to_numpy(self._alive),
            "radii": (lv.radii.copy() if booted
                      else np.zeros((L,), np.float32)),
            "center": (to_numpy(lv.center) if booted
                       else np.zeros((L, n), bool)),
            "assign": (to_numpy(lv.assign) if booted
                       else np.full((L, n), -1, np.int32)),
            "adist": (to_numpy(lv.adist) if booted
                      else np.zeros((L, n), np.float32)),
            "dirty": (lv.dirty.copy() if booted else np.zeros((L,), bool)),
            "frozen": (lv.frozen.copy() if booted
                       else np.zeros((L,), bool)),
            "cover": (lv.cover.copy() if booted
                      else np.zeros((L,), np.float32)),
        }
        meta = {"dim": self.dim, "metric": self.metric,
                "budget": self.budget,
                "policy": {"levels": self.policy.levels,
                           "max_deleted_frac": self.policy.max_deleted_frac,
                           "max_updates": self.policy.max_updates},
                "n_rows": n, "booted": booted,
                "inserts_total": self.inserts_total,
                "deletes_total": self.deletes_total,
                "updates_since_rebuild": self.updates_since_rebuild,
                "deletions_absorbed": self.deletions_absorbed,
                "rebuilds": self.rebuilds,
                "recertifications": (lv.recertifications if booted else 0),
                "phase_log": [[str(e), float(v)] for e, v in self._phase_log]}
        return arrays, meta

    def save(self, manager, step: int) -> None:
        """Blocking checkpoint at ``step`` (for a dynamic run: update ops
        applied so far) through a ``CheckpointManager`` of either
        package."""
        arrays, meta = self.state_dict()
        manager.save(step, arrays, extra=meta, blocking=True)
        _count("checkpoints_written")

    @classmethod
    def from_state_dict(cls, arrays, meta, *, device=None,
                        use_pallas="auto") -> "DynamicIndex":
        """Rebuild an index from ``state_dict()`` output — the port's, or
        the reference's — on ``device``."""
        pol = RebuildPolicy(**meta["policy"])
        idx = cls(dim=meta["dim"], metric=meta["metric"], policy=pol,
                  budget=int(meta["budget"]), device=device,
                  use_pallas=use_pallas)
        dev = idx.device

        def t(name, dtype):
            return torch.as_tensor(np.array(to_numpy(arrays[name])),
                                   dtype=dtype, device=dev)

        pts = t("points", torch.float32)
        n = int(pts.shape[0])
        if idx.dim is not None:
            idx._alloc(n, idx.dim)
            if n:
                idx._write_rows(0, pts.reshape(n, idx.dim))
            idx._alive_buf[:n] = t("alive", torch.bool)
        idx._n = n
        idx._n_alive = int(np.count_nonzero(to_numpy(arrays["alive"])))
        idx.inserts_total = int(meta["inserts_total"])
        idx.deletes_total = int(meta["deletes_total"])
        idx.updates_since_rebuild = int(meta["updates_since_rebuild"])
        idx.deletions_absorbed = int(meta["deletions_absorbed"])
        idx.rebuilds = int(meta["rebuilds"])
        idx._phase_log = [(str(e), float(v)) for e, v in meta["phase_log"]]
        if meta["booted"]:
            lv = idx._new_levels(np.array(to_numpy(arrays["radii"]),
                                          np.float32))
            lv.load(t("center", torch.bool), t("assign", torch.int32),
                    t("adist", torch.float32))
            lv.dirty = np.array(to_numpy(arrays["dirty"]), bool)
            lv.frozen = np.array(to_numpy(arrays["frozen"]), bool)
            lv.cover = np.array(to_numpy(arrays["cover"]), np.float32)
            lv.recertifications = int(meta.get("recertifications", 0))
            idx._levels = lv
        return idx

    @classmethod
    def restore(cls, manager, step: Optional[int] = None, *, device=None,
                use_pallas="auto"):
        """Rebuild a ``DynamicIndex`` from checkpoint ``step`` (default: the
        latest) through a ``CheckpointManager`` of either package.  Returns
        ``(index, step)``, or ``(None, None)`` when the directory holds no
        checkpoint yet."""
        if step is None:
            step = manager.latest_step()
            if step is None:
                return None, None
        meta = manager.read_meta(step)["extra"]
        L = int(meta["policy"]["levels"])
        n = int(meta["n_rows"])
        d = int(meta["dim"]) if meta["dim"] is not None else 0
        template = {
            "points": np.zeros((n, d), np.float32),
            "alive": np.zeros((n,), bool),
            "radii": np.zeros((L,), np.float32),
            "center": np.zeros((L, n), bool),
            "assign": np.zeros((L, n), np.int32),
            "adist": np.zeros((L, n), np.float32),
            "dirty": np.zeros((L,), bool),
            "frozen": np.zeros((L,), bool),
            "cover": np.zeros((L,), np.float32),
        }
        arrays = manager.restore(step, template)
        return cls.from_state_dict(arrays, meta, device=device,
                                   use_pallas=use_pallas), step
