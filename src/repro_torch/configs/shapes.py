"""Assigned input-shape set (LM family): every arch × these four cells.

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a KV cache
of the given length); ``train_*`` lowers ``train_step``; ``prefill_*`` lowers
the prefill serve path.  ``long_500k`` only applies to sub-quadratic archs
(cfg.supports_long_context) — skips are recorded in DESIGN.md / EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable(cfg, cell: ShapeCell) -> bool:
    if cell.name == "long_500k":
        return bool(cfg.supports_long_context)
    return True
