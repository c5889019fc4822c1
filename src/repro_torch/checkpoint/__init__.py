"""Checkpoints of the port, in the reference's on-disk layout (port of
``repro.checkpoint``)."""
from .manager import SCHEMA_VERSION, CheckpointError, CheckpointManager, \
    ShapeDtype

__all__ = ["SCHEMA_VERSION", "CheckpointError", "CheckpointManager",
           "ShapeDtype"]
