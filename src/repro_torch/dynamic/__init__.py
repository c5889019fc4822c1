"""Fully dynamic diversity on the port (port of ``repro.dynamic``):
``mode="dynamic"`` of the facade runs here.

* ``ops``     — the update-stream vocabulary (``Insert``/``Delete``);
* ``levels``  — leveled-cover maintenance on the device (insertion folds,
  deletion repair, lazy dirty-level re-certification), every distance a
  B3 tile and the greedy packing pass blocked;
* ``rebuild`` — the ``RebuildPolicy`` scheduler deciding when repair
  gives way to a from-scratch rebuild;
* ``index``   — ``DynamicIndex``: insert/delete/query entry points,
  certificate minting and the bit-identical checkpoint round-trip in the
  reference's layout.
"""
from .index import DynamicIndex, DynamicQueryResult
from .levels import LevelStructure
from .ops import (Delete, Insert, as_update_ops, is_update_stream,
                  stream_dim)
from .rebuild import RebuildPolicy, resolve_rebuild

__all__ = ["DynamicIndex", "DynamicQueryResult", "LevelStructure",
           "Insert", "Delete", "RebuildPolicy", "as_update_ops",
           "is_update_stream", "stream_dim", "resolve_rebuild"]
