"""Data utilities of the port (port of ``repro.data``): the synthetic
pipeline (``lm_batch``, the paper's point clouds, ``stream``) and
diversity-driven selection (``embed_examples``, ``select_diverse``,
``balanced_quotas``)."""
from .pipeline import clustered_dataset, lm_batch, sphere_dataset, stream
from .selection import balanced_quotas, embed_examples, select_diverse

__all__ = ["clustered_dataset", "lm_batch", "sphere_dataset", "stream",
           "balanced_quotas", "embed_examples", "select_diverse"]
