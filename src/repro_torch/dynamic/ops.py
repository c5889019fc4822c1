"""Update-stream vocabulary of ``mode="dynamic"`` (port of
``repro.dynamic.ops``).

A dynamic run's input is an *update stream*: a concrete list/tuple of
``Insert``/``Delete`` ops (or equivalent ``("insert", points)`` /
``("delete", ids)`` pairs).  The planner classifies the input and reads the
point dimensionality without consuming anything, which is why an update
stream is a materialized sequence — a generator of ops cannot be inspected
purely and is rejected at plan time.  The payloads may be numpy arrays or
tensors on any device; nothing here copies them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Insert:
    """Insert a ``(b, d)`` batch of points into the index.

    ``DynamicIndex.insert`` assigns each row a stable integer id
    (consecutive, in arrival order) and returns the ids — those ids are the
    handles later ``Delete`` ops name.
    """
    points: Any


@dataclasses.dataclass(frozen=True)
class Delete:
    """Delete previously inserted points by the ids ``insert`` returned."""
    ids: Any


_OP_TAGS = ("insert", "delete")


def _as_op(item) -> Optional[Union[Insert, Delete]]:
    """One stream element as an op, or None when it is not one."""
    if isinstance(item, (Insert, Delete)):
        return item
    if (isinstance(item, tuple) and len(item) == 2
            and isinstance(item[0], str) and item[0] in _OP_TAGS):
        return Insert(item[1]) if item[0] == "insert" else Delete(item[1])
    return None


def is_update_stream(points) -> bool:
    """True when ``points`` is a materialized update stream.

    Every element must be an op — a list of plain chunk arrays (the
    streaming input) or of ``(chunk, labels)`` pairs (constrained streams)
    never classifies as one, because their elements are arrays, not
    ``Insert``/``Delete``/tagged pairs.
    """
    if not isinstance(points, (list, tuple)) or len(points) == 0:
        return False
    return all(_as_op(item) is not None for item in points)


def as_update_ops(points) -> List[Union[Insert, Delete]]:
    """Normalize a dynamic-mode input to a list of ops.

    A bare ``(n, d)`` array or tensor is sugar for a one-op stream
    ``[Insert(arr)]`` (an index that never churns is just a batch problem
    with a resumable engine).
    """
    if hasattr(points, "shape") and hasattr(points, "dtype"):
        return [Insert(points)]
    if not isinstance(points, (list, tuple)):
        raise ValueError(
            "mode='dynamic' needs a materialized update stream (a list of "
            "repro_torch.Insert/repro_torch.Delete ops) or an (n, d) array; "
            f"got {type(points).__name__}")
    ops: List[Union[Insert, Delete]] = []
    for j, item in enumerate(points):
        op = _as_op(item)
        if op is None:
            raise ValueError(
                f"update stream element {j} is not an Insert/Delete op "
                f"(got {type(item).__name__})")
        ops.append(op)
    return ops


def stream_dim(points) -> Optional[int]:
    """Point dimensionality read off the first ``Insert`` op (pure: the
    payload's shape is read, never its values).  None when the stream has
    no insert."""
    for item in points:
        op = _as_op(item)
        if isinstance(op, Insert):
            shape = (tuple(op.points.shape) if hasattr(op.points, "shape")
                     else np.asarray(op.points).shape)
            if len(shape) >= 2:
                return int(shape[-1])
    return None
