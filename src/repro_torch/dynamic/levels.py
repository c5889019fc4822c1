"""Leveled cover maintenance for the dynamic index, on the index's device
(port of ``repro.dynamic.levels``).

The structure is the reference's: ``L`` independent levels with
geometrically halving radii ``r_0 > r_1 > ... > r_{L-1}`` (level 0 spans
the boot diameter).  Each *active* level ``l`` keeps two invariants over
the live points:

* **cover**: every live point is within ``r_l`` of its assigned center
  (``assign``/``adist`` record the center id and the measured distance);
* **packing**: centers are pairwise farther than ``r_l`` apart at creation
  time (greedy insertion; deletions only remove centers).

Levels whose center count outgrows ``max_centers`` are **frozen** until the
next rebuild (counts grow with depth, so the active prefix is contiguous),
and a level's cover radius is cached and re-measured only when the level
is dirtied.  All of this is the reference's semantics, decision for
decision, so the same update sequence builds the same structure.

What differs is where it runs.  The ``(L, n)`` ``center``/``assign``/
``adist`` arrays are tensors on the index's device in buffers whose
capacity doubles; the small per-level vectors (``radii``, ``dirty``,
``frozen``, ``cover``) stay on the host.  Every distance is a tile of the
owning index's oracle (``rows(ids)`` gathers the rows of the point store
as the distance function reads them, ``dist(a, b)`` is the ``(m, n)``
tile: the B3 kernel on the card).  The reference's greedy packing pass
reads ``mind[i]`` once per far point; here it is a **blocked greedy**
with a few host reads per block of ``BLOCK`` far points, whose result
equals the sequential loop's exactly:

* a far point is accepted iff its smallest distance to an already
  accepted point *earlier in fold order* is greater than ``r`` — inside a
  block this is resolved on the device in rounds over the candidates'
  adjacency (``_resolve``), each round deciding at least the first
  undecided candidate;
* a covered point's center is the nearest among those accepted *before
  it*, ties to the earliest accepted (the reference's strict ``row <
  mind`` update): every block's new centers fold into the running
  ``mind``/``near`` of the points from their own position on, with a
  strict ``<`` against what earlier blocks left there.

``host_syncs`` counts the reads of device values the maintenance makes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..obs.trace import count as _count

INF = float("inf")
# entries of one distance tile (an (m, n) float32 block is at most 256 MiB)
TILE_ENTRIES = 1 << 26
# resolution rounds between two reads of "anything left undecided"
ROUNDS_PER_READ = 4
# far points a block of the greedy packing pass (the result does not
# depend on it: any partition gives the sequential loop's answer)
BLOCK = 4096


class Rows(NamedTuple):
    """Rows of the point store as the distance oracle reads them: the
    (normalized, for cosine) points and their squared norms (euclidean;
    None otherwise)."""
    points: torch.Tensor
    sq: Optional[torch.Tensor]


def take(rows: Rows, idx) -> Rows:
    return Rows(rows.points.index_select(0, idx),
                None if rows.sq is None else rows.sq.index_select(0, idx))


def cut(rows: Rows, s: int, e: int) -> Rows:
    return Rows(rows.points[s:e], None if rows.sq is None else rows.sq[s:e])


def _resolve(adj: torch.Tensor, syncs: list) -> torch.Tensor:
    """The sequential greedy over ``c`` candidates in order, on the device:
    candidate ``b`` is accepted iff no accepted ``a < b`` has
    ``adj[a, b]``.  Each round decides every undecided candidate that is
    covered by an accepted one (rejected) or has no undecided earlier
    neighbour left (accepted), from the states at the round's start; the
    first undecided candidate is always decided, so at most ``c`` rounds
    run.  Returns the accepted mask."""
    c = adj.shape[0]
    adj = torch.triu(adj, diagonal=1)
    und = torch.ones((c,), dtype=torch.bool, device=adj.device)
    acc = torch.zeros_like(und)
    done = 0
    while done < c:
        for _ in range(ROUNDS_PER_READ):
            hit = (adj & acc[:, None]).any(dim=0)
            blocked = (adj & und[:, None]).any(dim=0)
            acc = acc | (und & ~hit & ~blocked)
            und = und & ~hit & blocked
        done += ROUNDS_PER_READ
        syncs[0] += 1
        if not bool(und.any()):
            break
    return acc


class LevelStructure:
    """The per-level cover state: ``(L, cap)`` center mask, assignment and
    measured assignment distance on the device (the first ``n`` columns
    are the rows inserted so far), per-level dirty/frozen flags and the
    cached cover radius on the host.  ``rows(ids)`` and ``dist(a, b)`` are
    the owning index's distance oracle."""

    def __init__(self, radii, rows: Callable, dist: Callable,
                 max_centers: int, device) -> None:
        self.radii = np.asarray(radii, np.float32)
        self.L = int(self.radii.shape[0])
        self._rows = rows
        self._dist = dist
        self.max_centers = int(max_centers)
        self.device = torch.device(device)
        self.block = BLOCK
        self.n = 0
        self._alloc(0)
        self.dirty = np.zeros((self.L,), bool)
        self.frozen = np.zeros((self.L,), bool)
        self.cover = np.zeros((self.L,), np.float32)
        self.recertifications = 0
        self._syncs = [0]

    @property
    def host_syncs(self) -> int:
        return self._syncs[0]

    def _read(self, x):
        """One host read of a device value (counted)."""
        self._syncs[0] += 1
        return x.item() if isinstance(x, torch.Tensor) else x

    def _nonzero(self, mask) -> torch.Tensor:
        """Indices of a mask (a host read of its count, counted)."""
        self._syncs[0] += 1
        return torch.nonzero(mask).flatten()

    # -- storage -------------------------------------------------------------
    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.center_buf = torch.zeros((self.L, cap), dtype=torch.bool,
                                      device=dev)
        # int32 assignment ids, as the reference (and its checkpoints) keep
        self.assign_buf = torch.full((self.L, cap), -1, dtype=torch.int32,
                                     device=dev)
        self.adist_buf = torch.zeros((self.L, cap), dtype=torch.float32,
                                     device=dev)

    @property
    def center(self) -> torch.Tensor:
        return self.center_buf[:, :self.n]

    @property
    def assign(self) -> torch.Tensor:
        return self.assign_buf[:, :self.n]

    @property
    def adist(self) -> torch.Tensor:
        return self.adist_buf[:, :self.n]

    def ensure_rows(self, n: int) -> None:
        """Make room for ``n`` rows: the capacity at least doubles when it
        grows, so a stream of inserts copies O(n) entries in all."""
        cap = self.center_buf.shape[1]
        if n > cap:
            old = (self.center_buf, self.assign_buf, self.adist_buf)
            self._alloc(max(n, 2 * cap))
            for new, o in zip((self.center_buf, self.assign_buf,
                               self.adist_buf), old):
                new[:, :self.n] = o[:, :self.n]
        self.n = max(self.n, n)

    def load(self, center, assign, adist) -> None:
        """Install checkpointed ``(L, n)`` arrays (tensors on the device)."""
        self.n = 0
        self._alloc(int(center.shape[1]))
        self.n = int(center.shape[1])
        self.center_buf.copy_(center)
        self.assign_buf.copy_(assign)
        self.adist_buf.copy_(adist)

    def center_counts(self, alive) -> np.ndarray:
        """Live center count of every level, in one host read."""
        self._syncs[0] += 1
        return (self.center & alive[None, :]).sum(dim=1).cpu().numpy()

    def n_centers(self, lev: int, alive) -> int:
        return int(self._read((self.center[lev] & alive).sum()))

    def centers_of(self, lev: int, alive) -> torch.Tensor:
        """Live center ids of one level, ascending (stable query order)."""
        return self._nonzero(self.center[lev] & alive)

    # -- cover maintenance ---------------------------------------------------
    def _fold(self, lev: int, ids: torch.Tensor) -> bool:
        """Fold ``ids`` (an int64 tensor, in the given order) into level
        ``lev``: points within ``r_l`` of a center are absorbed (nearest
        center, ties to the lowest id), the rest are promoted by the
        blocked greedy packing pass.  Returns True iff the center set
        changed."""
        r = float(self.radii[lev])
        if ids.numel() == 0:
            return False
        cen = self._nonzero(self.center[lev])
        far = ids
        if cen.numel():
            crows = self._rows(cen)
            j = torch.empty_like(ids)
            dnear = torch.empty(ids.shape, dtype=torch.float32,
                                device=ids.device)
            step = max(1, TILE_ENTRIES // cen.numel())
            for s in range(0, ids.numel(), step):
                D = self._dist(self._rows(ids[s:s + step]), crows)
                jj = torch.argmin(D, dim=1)
                j[s:s + step] = jj
                dnear[s:s + step] = D.gather(1, jj[:, None])[:, 0]
            covered = dnear <= r
            cpos = self._nonzero(covered)
            if cpos.numel():
                cov = ids[cpos]
                self.assign_buf[lev, cov] = cen[j[cpos]].to(torch.int32)
                self.adist_buf[lev, cov] = dnear[cpos]
                if not self.dirty[lev]:
                    # pure absorption keeps the cached cover radius exact
                    self.cover[lev] = max(self.cover[lev], float(
                        self._read(dnear[cpos].max())))
            far = ids[self._nonzero(~covered)]
        if far.numel() == 0:
            return False
        self._greedy(lev, far, r)
        self.dirty[lev] = True
        return True

    def _greedy(self, lev: int, far: torch.Tensor, r: float) -> None:
        """The reference's sequential packing pass over ``far`` (accept a
        point unless an earlier accepted one is within ``r``; a covered
        point takes the nearest earlier accepted center, ties to the
        earliest), blocked: the far rows are gathered once, and each block
        of ``self.block`` of them costs one candidate tile, the device
        resolution of ``_resolve`` and one tile of its new centers against
        the rows from the block on."""
        F = far.numel()
        dev = far.device
        frows = self._rows(far)
        mind = torch.full((F,), INF, dtype=torch.float32, device=dev)
        near = torch.zeros((F,), dtype=torch.int64, device=dev)
        acc = torch.zeros((F,), dtype=torch.bool, device=dev)
        for s in range(0, F, self.block):
            e = min(F, s + self.block)
            pos = self._nonzero(mind[s:e] > r) + s
            if pos.numel() == 0:
                continue                 # every point of the block covered
            if pos.numel() == 1:
                new = pos
            else:
                prow = take(frows, pos)
                keep = _resolve(self._dist(prow, prow) <= r, self._syncs)
                new = pos[self._nonzero(keep)]
            acc[new] = True
            nrows = take(frows, new)
            step = max(1, TILE_ENTRIES // new.numel())
            for cs in range(s, F, step):
                ce = min(F, cs + step)
                T = self._dist(nrows, cut(frows, cs, ce))
                if cs < e:
                    # a center counts only for the points after it
                    col = torch.arange(cs, ce, device=dev)
                    T = T.masked_fill(new[:, None] >= col[None, :], INF)
                a = torch.argmin(T, dim=0)
                v = T.gather(0, a[None, :])[0]
                upd = v < mind[cs:ce]
                mind[cs:ce] = torch.where(upd, v, mind[cs:ce])
                near[cs:ce] = torch.where(upd, new[a], near[cs:ce])
        far32 = far.to(torch.int32)
        self.center_buf[lev, far] = acc
        self.assign_buf[lev, far] = torch.where(acc, far32, far32[near])
        self.adist_buf[lev, far] = torch.where(acc, torch.zeros_like(mind),
                                               mind)

    def _freeze_if_saturated(self, lev: int, alive) -> bool:
        """Freeze ``lev`` (and everything finer — counts only grow with
        depth) once its center count outruns the freeze cap."""
        if self.n_centers(lev, alive) > self.max_centers:
            self.frozen[lev:] = True
            return True
        return False

    def insert(self, ids: torch.Tensor, alive) -> None:
        """Fold an inserted batch into every active level, freezing levels
        that saturate past ``max_centers``."""
        for lev in range(self.L):
            if self.frozen[lev]:
                break
            self._fold(lev, ids)
            if self._freeze_if_saturated(lev, alive):
                break

    def delete(self, dead: torch.Tensor, alive) -> None:
        """Repair every active level after ``dead`` ids went tombstone.

        Deleted members simply vanish (the cached cover radius stays a
        sound upper bound).  Deleted *centers* dirty the level: their live
        orphans are re-folded in ascending id order — reassigned when a
        surviving center covers them, promoted otherwise.
        """
        for lev in range(self.L):
            if self.frozen[lev]:
                break
            dead_centers = dead[self._nonzero(self.center[lev, dead])]
            if dead_centers.numel() == 0:
                continue
            self.center_buf[lev, dead_centers] = False
            orphaned = alive & torch.isin(self.assign[lev],
                                          dead_centers.to(torch.int32))
            self.assign_buf[lev, dead_centers] = -1
            self.dirty[lev] = True
            self._fold(lev, self._nonzero(orphaned))
            if self._freeze_if_saturated(lev, alive):
                break

    def rebuild(self, alive) -> int:
        """From-scratch greedy build of every level over the live points (in
        ascending id order), reactivating frozen depth as far as the live
        set affords.  Returns the number of levels (re)built."""
        ids = self._nonzero(alive)
        self.center_buf.fill_(False)
        self.assign_buf.fill_(-1)
        self.adist_buf.fill_(0.0)
        self.dirty[:] = True
        self.frozen[:] = False
        built = 0
        for lev in range(self.L):
            self._fold(lev, ids)
            built += 1
            _count("level_rebuilds")
            if self._freeze_if_saturated(lev, alive):
                break
        return built

    # -- certification -------------------------------------------------------
    def cover_radius(self, lev: int, alive) -> float:
        """Measured cover radius of one level (max live assignment
        distance).  Dirty levels re-measure (and re-certify) lazily; clean
        levels serve the cached sound upper bound."""
        if self.dirty[lev]:
            live = alive & (self.assign[lev] >= 0)
            # adist >= 0, so the max over the live entries is the max of
            # the live-masked row (0 when no entry is live)
            self.cover[lev] = self._read(torch.where(
                live, self.adist[lev], 0.0).max()) if self.n else 0.0
            self.dirty[lev] = False
            self.recertifications += 1
        return float(self.cover[lev])

    # -- query-level selection ----------------------------------------------
    def select_level(self, budget: int, k: int, alive) -> Optional[int]:
        """The finest affordable level: among active levels with at most
        ``budget`` live centers, the one with the most (ties -> finer);
        when none of those reaches ``k`` centers, fall back to the coarsest
        active level with at least ``k``.  None when no level qualifies
        (the caller solves on the live points directly)."""
        counts = self.center_counts(alive)
        best, best_n = None, -1
        fallback = None
        for lev in range(self.L):
            if self.frozen[lev]:
                break
            n_c = int(counts[lev])
            if n_c <= budget and n_c >= best_n:
                best, best_n = lev, n_c
            if fallback is None and n_c >= k:
                fallback = lev
        if best is not None and best_n >= k:
            return best
        return fallback
