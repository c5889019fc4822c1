"""Rebuild scheduling for the dynamic index (port of
``repro.dynamic.rebuild``, unchanged).

Incremental maintenance keeps every *active* level a valid cover after
each insert/delete batch, but two things still degrade with churn:

* deletions since the last rebuild leave tombstoned rows and repaired
  covers whose packing slowly loosens (a repaired orphan promoted to a
  center can sit closer to its neighbors than a from-scratch greedy pass
  would place it);
* saturated (frozen) levels stop being maintained entirely and only a
  rebuild can reactivate them against the current live set.

``RebuildPolicy`` decides when the index stops repairing and rebuilds its
level structure from scratch over the live points.  The triggers are
deliberately simple and deterministic — the same update sequence always
rebuilds at the same step, which is what makes checkpoints replayable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    """When does the dynamic index rebuild its levels from scratch?

    ``levels`` is the depth of the cover hierarchy (level 0 spans the boot
    diameter; each level halves the radius).  ``max_deleted_frac`` triggers
    a rebuild once deletions since the last rebuild exceed that fraction of
    the points the structure has covered since then; ``max_updates``
    (None = off) additionally caps the total insert+delete count between
    rebuilds.
    """
    levels: int = 10
    max_deleted_frac: float = 0.5
    max_updates: Optional[int] = None

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if not (0.0 < self.max_deleted_frac <= 1.0):
            raise ValueError("max_deleted_frac must be in (0, 1], got "
                             f"{self.max_deleted_frac}")
        if self.max_updates is not None and self.max_updates < 1:
            raise ValueError(
                f"max_updates must be >= 1 or None, got {self.max_updates}")

    def should_rebuild(self, *, updates_since_rebuild: int,
                       deletions_absorbed: int, n_alive: int) -> bool:
        """Deterministic trigger, evaluated after every applied op."""
        if self.max_updates is not None \
                and updates_since_rebuild >= self.max_updates:
            return True
        seen = n_alive + deletions_absorbed    # live now + gone since rebuild
        return deletions_absorbed > self.max_deleted_frac * max(seen, 1)

    def describe(self) -> str:
        """One-line rendering for ``plan.explain()`` and telemetry."""
        cap = "off" if self.max_updates is None else str(self.max_updates)
        return (f"levels={self.levels}, "
                f"max_deleted_frac={self.max_deleted_frac}, "
                f"max_updates={cap}")


def resolve_rebuild(knob) -> RebuildPolicy:
    """Resolve the ``ExecutionSpec.rebuild`` knob ("auto" | None |
    RebuildPolicy)."""
    if knob is None or knob == "auto":
        return RebuildPolicy()
    if not isinstance(knob, RebuildPolicy):
        raise TypeError("rebuild= must be a repro_torch.dynamic."
                        "RebuildPolicy or 'auto', got "
                        f"{type(knob).__name__}")
    return knob
