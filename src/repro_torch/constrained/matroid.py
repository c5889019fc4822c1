"""Pluggable matroid oracles for constrained diversity maximization (port
of ``repro.constrained.matroid``: numpy only, kept as the port's own copy so
that importing it pulls in no JAX).

The constrained solver stack (greedy + exchange local search on a composed
core-set) is correct for *any* matroid — Ceccarello–Pietracaprina–Pucci's
"A General Coreset-Based Approach to Diversity Maximization under Matroid
Constraints" (arXiv:2002.03175) shows the approximation guarantees of the
partition-matroid pipeline carry over unchanged.  This module supplies the
oracle interface that lets every layer (solver, core-set, streaming, MR,
serving) stay matroid-agnostic.

Design: label-count matroids
----------------------------

All matroids shipped here are defined over the ``m`` group labels already
threaded through the subsystem: every point carries a label ``g ∈ [0, m)``
and independence of a selection ``S`` depends only on its *count vector*
``c[g] = |S ∩ G_g|``.  That single restriction buys a lot:

* the independence oracle is a cheap pure function of an ``(m,)`` int array
  (``counts_feasible``), so the greedy's feasibility mask and the local
  search's swap mask vectorize over all n candidates at once — no per-pair
  oracle calls inside the hot loops;
* the matroid-coreset composition theorem applies verbatim: the groups are
  the categories, so the existing per-group GMM/SMM/MR core-set builders
  serve every matroid unchanged (a feasible solution takes ≤ k points from
  any one group, which is exactly what the per-group core-sets are sized
  for);
* exchangeability (the matroid axiom) is inherited from the classic proofs
  for each concrete family — partition, transversal, laminar are all bona
  fide matroids (the quota-range extension adds a lower-bound side
  constraint handled by the greedy's deficit reservation).

Concrete implementations
------------------------

``PartitionMatroid``   exact quotas ``|S ∩ G_g| = q_g`` (bit-identical to the
                       pre-oracle quota path) or ranges
                       ``q_min[g] ≤ |S ∩ G_g| ≤ q_max[g]`` with a total
                       cardinality ``k`` — what fair-serving SLOs actually
                       express.
``TransversalMatroid`` a bipartite eligibility relation between groups and
                       ``r`` slots; ``S`` is independent iff its points can
                       be matched to distinct slots (checked by max-flow on
                       the count vector).  Models "each pick must occupy one
                       of r roles, and its group decides which roles it may
                       fill".
``LaminarMatroid``     a laminar (nested-or-disjoint) family of group sets,
                       each with a capacity: ``|S ∩ F| ≤ cap(F)``.  Models
                       hierarchical caps ("≤ 4 from EMEA, of which ≤ 2 from
                       any one country").

Example
-------

>>> import numpy as np
>>> from repro_torch.constrained.matroid import PartitionMatroid, LaminarMatroid
>>> pm = PartitionMatroid([2, 1])           # exact quotas, k = 3
>>> pm.k, pm.m
(3, 2)
>>> pm.independence_oracle(np.array([0, 0, 1]))
True
>>> pm.independence_oracle(np.array([0, 0, 0]))   # 3 picks from group 0
False
>>> lam = LaminarMatroid(4, [([0, 1], 2), ([0, 1, 2, 3], 3)], k=3)
>>> lam.counts_feasible(np.array([1, 1, 1, 0]))
True
>>> lam.counts_feasible(np.array([2, 1, 0, 0]))   # |S ∩ {0,1}| = 3 > 2
False
"""
from __future__ import annotations

import abc
import itertools
import math
from typing import Iterator, Optional, Sequence

import numpy as np


class Matroid(abc.ABC):
    """Label-count matroid over ``m`` groups with target basis size ``k``.

    Subclasses implement ``counts_feasible`` — the independence oracle on a
    per-group count vector — and may override the derived vectorized hooks
    (``grow_mask``, ``swap_mask``) when a closed form beats the generic
    one-oracle-call-per-group fallback.

    ``k`` is the solution cardinality every driver targets (the basis size);
    for pure matroids any maximal independent set has this size, so the
    greedy cannot get stuck.  ``PartitionMatroid`` with lower quotas adds a
    side constraint and overrides ``grow_mask`` to reserve deficit slots.
    """

    #: number of label categories; labels must lie in [0, m)
    m: int
    #: target solution size (Σ quotas / #slots / root capacity)
    k: int

    # ---------------------------------------------------------------- oracle

    @abc.abstractmethod
    def counts_feasible(self, counts: np.ndarray) -> bool:
        """Independence oracle: may a selection have these per-group counts?"""

    def independence_oracle(self, sel_labels) -> bool:
        """Independence of an explicit selection, given its labels.

        ``sel_labels`` is the ``(|S|,)`` int label array of the selected
        points (point identity is irrelevant for label-count matroids).
        """
        lab = np.asarray(sel_labels, np.int64)
        if lab.size and (lab.min() < 0 or lab.max() >= self.m):
            return False
        return self.counts_feasible(np.bincount(lab, minlength=self.m))

    def rank(self, labels) -> int:
        """Rank of the multiset ``labels`` — the size of its largest
        independent subset, via the (exact, by the matroid axiom) greedy:
        keep adding one element from any group while independence holds."""
        avail = np.bincount(np.asarray(labels, np.int64), minlength=self.m)
        c = np.zeros(self.m, np.int64)
        while True:
            grew = False
            for g in range(self.m):
                while c[g] < avail[g]:
                    c[g] += 1
                    if self.counts_feasible(c):
                        grew = True
                    else:
                        c[g] -= 1
                        break
            if not grew:
                return int(c.sum())

    def basis_feasible(self, counts: np.ndarray) -> bool:
        """Is this the count vector of a *complete feasible solution* —
        independent, of full size k, and meeting any lower-bound side
        constraints (none for pure matroids)?"""
        return int(counts.sum()) == self.k and self.counts_feasible(counts)

    # ----------------------------------------------------- vectorized hooks

    def grow_mask(self, counts: np.ndarray) -> np.ndarray:
        """(m,) bool — groups from which adding one point keeps the partial
        selection independent *and extendable* to a full solution.  Generic
        fallback: one oracle call per group (pure matroids are always
        extendable — every maximal independent set is a basis)."""
        out = np.zeros(self.m, bool)
        c = np.asarray(counts, np.int64).copy()
        for g in range(self.m):
            c[g] += 1
            out[g] = self.counts_feasible(c)
            c[g] -= 1
        return out

    def swap_mask(self, counts: np.ndarray, out_group: int) -> np.ndarray:
        """(m,) bool — groups g such that swapping one selected point of
        ``out_group`` for an unselected point of group g keeps the solution
        complete and feasible.  Generic fallback: oracle per group."""
        out = np.zeros(self.m, bool)
        c = np.asarray(counts, np.int64).copy()
        c[out_group] -= 1
        for g in range(self.m):
            c[g] += 1
            out[g] = self.basis_feasible(c)
            c[g] -= 1
        return out

    # ------------------------------------------------------------ validation

    def validate_ground_set(self, labels) -> None:
        """Raise ValueError when a label is out of range (the engine's -1
        pad sentinel must never reach the solver layer — the greedy's mask
        gather would wrap it to group m-1) or when no feasible solution of
        size k can exist in this label multiset (rank deficit or unmeetable
        lower quota)."""
        lab = np.asarray(labels, np.int64)
        if lab.size and (lab.min() < 0 or lab.max() >= self.m):
            bad = lab.max() if lab.max() >= self.m else lab.min()
            raise ValueError(f"label {bad} out of range for m={self.m}")
        r = self.rank(lab)
        if r < self.k:
            raise ValueError(f"matroid rank {r} on the candidate set < "
                             f"target k={self.k}; quotas infeasible for the "
                             f"candidate set")

    # --------------------------------------------- exact-path support (tests)

    def basis_count_vectors(self, avail: np.ndarray, *,
                            limit: int = 200_000) -> Iterator[np.ndarray]:
        """Yield every feasible full-solution count vector ``c`` with
        ``c ≤ avail`` and ``Σc = k`` (the brute-force solver enumerates
        per-group combinations within each).  Generic product enumeration
        with a hard cap — test scale only."""
        avail = np.asarray(avail, np.int64)
        caps = np.minimum(avail, self.k)
        seen = 0
        for combo in itertools.product(*(range(int(c) + 1) for c in caps)):
            seen += 1
            if seen > limit:
                raise ValueError("basis enumeration too large; raise "
                                 "exact_limit=0 to force the greedy path")
            c = np.asarray(combo, np.int64)
            if self.basis_feasible(c):
                yield c

    def search_space_size(self, labels, *, cap: int = 10 ** 9) -> int:
        """Σ over feasible count vectors of Π_g C(avail_g, c_g) — the exact
        solver's enumeration cost, saturating at ``cap`` (pass the caller's
        threshold as ``cap`` so a huge space bails at the first feasible
        vector instead of enumerating them all)."""
        avail = np.bincount(np.asarray(labels, np.int64), minlength=self.m)
        total = 0
        try:
            for c in self.basis_count_vectors(avail):
                total += math.prod(math.comb(int(a), int(q))
                                   for a, q in zip(avail, c))
                if total > cap:
                    return total
        except ValueError:
            return cap + 1
        return total


class PartitionMatroid(Matroid):
    """Per-group quotas — exact (``quotas=``) or ranged (``q_min``/``q_max``).

    ``PartitionMatroid(quotas)`` reproduces the original hard-coded quota
    path bit-for-bit: the greedy's feasibility mask reduces to
    ``counts < quotas`` and the swap mask to "same group only".

    With ranges, independence is ``counts ≤ q_max`` and a complete solution
    additionally needs ``counts ≥ q_min`` and ``Σ counts = k``; the lower
    bounds are a side constraint (not matroid-expressible), handled by the
    greedy's deficit reservation: once the remaining budget equals the total
    lower-bound deficit, only deficit groups may receive picks.

    >>> pm = PartitionMatroid(q_min=[1, 0, 0], q_max=[2, 2, 2], k=4)
    >>> bool(pm.grow_mask(np.array([0, 2, 1]))[1])   # group 1 at its cap
    False
    >>> bool(pm.grow_mask(np.array([0, 2, 1]))[0])   # must reserve group 0
    True
    """

    def __init__(self, quotas=None, *, q_min=None, q_max=None,
                 k: Optional[int] = None):
        if quotas is not None:
            if q_min is not None or q_max is not None:
                raise ValueError("pass either quotas= or q_min=/q_max=")
            q = np.asarray(quotas, np.int64)
            self.q_min = q.copy()
            self.q_max = q.copy()
        else:
            if q_max is None:
                raise ValueError("q_max is required when quotas is omitted")
            self.q_max = np.asarray(q_max, np.int64)
            self.q_min = (np.zeros_like(self.q_max) if q_min is None
                          else np.asarray(q_min, np.int64))
        if self.q_min.shape != self.q_max.shape:
            raise ValueError(f"q_min shape {self.q_min.shape} != q_max "
                             f"shape {self.q_max.shape}")
        if np.any(self.q_min < 0) or np.any(self.q_min > self.q_max):
            raise ValueError("need 0 <= q_min <= q_max per group")
        self.m = int(self.q_max.shape[0])
        lo, hi = int(self.q_min.sum()), int(self.q_max.sum())
        if k is None:
            if lo != hi:
                raise ValueError(f"quota ranges need an explicit k in "
                                 f"[{lo}, {hi}]")
            k = hi
        if not lo <= k <= hi:
            raise ValueError(f"k={k} outside [{lo}, {hi}] = "
                             f"[Σ q_min, Σ q_max]")
        self.k = int(k)
        #: True when q_min == q_max — the original exact-quota special case
        self.exact = bool(np.all(self.q_min == self.q_max))

    @property
    def quotas(self) -> np.ndarray:
        """Exact quota vector (only meaningful when ``self.exact``)."""
        return self.q_max

    def counts_feasible(self, counts: np.ndarray) -> bool:
        counts = np.asarray(counts, np.int64)
        return bool(np.all(counts <= self.q_max) and counts.sum() <= self.k)

    def basis_feasible(self, counts: np.ndarray) -> bool:
        counts = np.asarray(counts, np.int64)
        return bool(counts.sum() == self.k
                    and np.all(counts <= self.q_max)
                    and np.all(counts >= self.q_min))

    def grow_mask(self, counts: np.ndarray) -> np.ndarray:
        counts = np.asarray(counts, np.int64)
        room = counts < self.q_max
        deficit = np.maximum(self.q_min - counts, 0)
        remaining = self.k - int(counts.sum())
        if int(deficit.sum()) >= remaining:
            # every remaining pick must service a lower-bound deficit; for
            # exact quotas this is ALWAYS the active branch and reduces to
            # the original ``rem[labels] > 0`` mask
            return (deficit > 0) & room
        return room

    def swap_mask(self, counts: np.ndarray, out_group: int) -> np.ndarray:
        counts = np.asarray(counts, np.int64)
        c = counts.copy()
        c[out_group] -= 1
        if c[out_group] < self.q_min[out_group]:
            # removing from a group already at its lower bound: the
            # replacement must come from the same group (exact quotas land
            # here for every group — the original same-group-swap rule)
            out = np.zeros(self.m, bool)
            out[out_group] = True
            return out
        return c < self.q_max

    def basis_count_vectors(self, avail: np.ndarray, *,
                            limit: int = 200_000) -> Iterator[np.ndarray]:
        if self.exact:  # single vector — the original per-group enumeration
            if np.all(self.q_max <= np.asarray(avail, np.int64)):
                yield self.q_max.copy()
            return
        yield from super().basis_count_vectors(avail, limit=limit)

    def validate_ground_set(self, labels) -> None:
        # keep the original, more specific error for the exact path
        lab = np.asarray(labels, np.int64)
        if lab.size and (lab.min() < 0 or lab.max() >= self.m):
            bad = lab.max() if lab.max() >= self.m else lab.min()
            raise ValueError(f"label {bad} out of range for m={self.m}")
        counts = np.bincount(lab, minlength=self.m)[:self.m]
        short = np.where(counts < self.q_min)[0]
        if short.size:
            g = int(short[0])
            raise ValueError(f"group {g} has {counts[g]} points < quota "
                             f"{int(self.q_min[g])}")
        if int(np.minimum(counts, self.q_max).sum()) < self.k:
            raise ValueError(f"candidate set supports at most "
                             f"{int(np.minimum(counts, self.q_max).sum())} "
                             f"feasible picks < k={self.k}; quotas "
                             f"infeasible for the candidate set")


class TransversalMatroid(Matroid):
    """Partial-transversal matroid over ``r`` slots with a group-level
    eligibility relation.

    ``eligibility`` is an ``(m, r)`` bool array: a point of group g may
    occupy slot s iff ``eligibility[g, s]``.  A selection is independent iff
    its points can be matched to *distinct* slots — checked on the count
    vector by unit-capacity max-flow (groups are supplies, slots are unit
    sinks), equivalent to Hall's condition.

    ``k`` defaults to ``r`` (fill every slot); pass a smaller ``k`` for a
    truncated transversal matroid.

    >>> elig = np.array([[1, 1, 0], [0, 1, 1], [0, 0, 1]], bool)
    >>> tm = TransversalMatroid(elig)
    >>> tm.counts_feasible(np.array([1, 1, 1]))      # g0→s0, g1→s1, g2→s2
    True
    >>> tm.counts_feasible(np.array([2, 0, 1]))      # g0 covers s0 AND s1
    True
    >>> tm.counts_feasible(np.array([0, 0, 2]))      # two g2 both need s2
    False
    """

    def __init__(self, eligibility, *, k: Optional[int] = None):
        self.eligibility = np.asarray(eligibility, bool)
        if self.eligibility.ndim != 2:
            raise ValueError("eligibility must be (m, r) bool")
        self.m, self.r = map(int, self.eligibility.shape)
        if np.any(~self.eligibility.any(axis=1)):
            g = int(np.where(~self.eligibility.any(axis=1))[0][0])
            raise ValueError(f"group {g} is eligible for no slot")
        self.k = self.r if k is None else int(k)
        if not 1 <= self.k <= self.r:
            raise ValueError(f"k={self.k} outside [1, r={self.r}]")

    def counts_feasible(self, counts: np.ndarray) -> bool:
        counts = np.asarray(counts, np.int64)
        total = int(counts.sum())
        if total > self.k:
            return False
        return self._max_matching(counts) == total

    def _max_matching(self, counts: np.ndarray) -> int:
        """Max bipartite matching of ``counts`` group-supplies into unit
        slots — augmenting-path max-flow; the graph is (m, r) tiny."""
        slot_of = np.full(self.r, -1, np.int64)   # slot -> group or -1
        matched = 0

        def augment(g: int, visited: np.ndarray) -> bool:
            for s in np.where(self.eligibility[g] & ~visited)[0]:
                visited[s] = True
                if slot_of[s] < 0 or augment(int(slot_of[s]), visited):
                    slot_of[s] = g
                    return True
            return False

        for g in range(self.m):
            for _ in range(int(counts[g])):
                if augment(g, np.zeros(self.r, bool)):
                    matched += 1
                else:
                    break  # supplies of g are interchangeable
        return matched


class LaminarMatroid(Matroid):
    """Laminar matroid: nested-or-disjoint group families with capacities.

    ``families`` is a sequence of ``(groups, capacity)`` pairs where
    ``groups`` lists member group ids; independence requires
    ``|S ∩ F| ≤ cap(F)`` for every family F.  The family must be laminar
    (every two sets nested or disjoint) — validated at construction.

    ``k`` defaults to the capacity of a root family covering all m groups
    (add one if your family has no root).

    >>> lam = LaminarMatroid(3, [([0, 1], 1), ([0, 1, 2], 2)])
    >>> lam.k
    2
    >>> lam.counts_feasible(np.array([1, 1, 0]))     # |S ∩ {0,1}| = 2 > 1
    False
    >>> lam.counts_feasible(np.array([1, 0, 1]))
    True
    """

    def __init__(self, m: int, families: Sequence, *,
                 k: Optional[int] = None):
        self.m = int(m)
        self._sets = []
        self._caps = []
        for groups, cap in families:
            mask = np.zeros(self.m, bool)
            g = np.asarray(list(groups), np.int64)
            if g.size and (g.min() < 0 or g.max() >= self.m):
                raise ValueError(f"family group ids {g} out of [0, {self.m})")
            mask[g] = True
            self._sets.append(mask)
            self._caps.append(int(cap))
        for i, a in enumerate(self._sets):
            for b_mask in self._sets[i + 1:]:
                inter = a & b_mask
                if inter.any() and not (np.array_equal(inter, a)
                                        or np.array_equal(inter, b_mask)):
                    raise ValueError("family is not laminar: sets "
                                     "overlap without nesting")
        self.sets = np.asarray(self._sets, bool)        # (F, m)
        self.caps = np.asarray(self._caps, np.int64)    # (F,)
        if k is None:
            root = np.where(self.sets.all(axis=1))[0]
            if root.size == 0:
                raise ValueError("no root family covering all groups; "
                                 "pass k= explicitly")
            k = int(self.caps[root].min())
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")

    def counts_feasible(self, counts: np.ndarray) -> bool:
        counts = np.asarray(counts, np.int64)
        if counts.sum() > self.k:
            return False
        return bool(np.all(self.sets @ counts <= self.caps))

    def grow_mask(self, counts: np.ndarray) -> np.ndarray:
        counts = np.asarray(counts, np.int64)
        if int(counts.sum()) >= self.k:
            return np.zeros(self.m, bool)
        # adding one point of group g bumps exactly the families containing
        # g: feasible iff none of them is already at capacity
        slack = (self.sets @ counts) < self.caps        # (F,)
        return ~np.any(self.sets & ~slack[:, None], axis=0)


def derive_mk(matroid: Optional[Matroid], m: Optional[int],
              k: Optional[int], who: str) -> tuple:
    """Resolve the ``(matroid=, m=, k=)`` triple the core-set builders
    accept: the oracle supplies missing values, explicit values must agree
    with it, and at least one source must cover both."""
    if matroid is not None:
        m = matroid.m if m is None else m
        k = matroid.k if k is None else k
        if m != matroid.m or k != matroid.k:
            raise ValueError(f"{who}: explicit (m={m}, k={k}) disagree with "
                             f"matroid (m={matroid.m}, k={matroid.k})")
    if m is None or k is None:
        raise ValueError(f"{who} needs m and k (or matroid= to derive them)")
    return m, k


def as_matroid(matroid: Optional[Matroid] = None, quotas=None) -> Matroid:
    """Normalize the ``(matroid=, quotas=)`` pair every driver accepts:
    ``quotas=`` is sugar for an exact-quota ``PartitionMatroid``."""
    if matroid is not None:
        if quotas is not None:
            raise ValueError("pass either matroid= or quotas=, not both")
        if not isinstance(matroid, Matroid):
            raise TypeError(f"matroid must be a Matroid, got "
                            f"{type(matroid).__name__}")
        return matroid
    if quotas is None:
        raise ValueError("either matroid= or quotas= is required")
    return PartitionMatroid(quotas)
