"""The model-backed serving engine (``ServingEngine``, ``diverse_rerank``)
of the reference's ``repro.serving.engine``: ROADMAP A, slice 16 (model zoo
and training), which brings the models it decodes with.  Both names raise
``NotImplementedError``; the rerank layer they sit on is
``serving.rerank``."""
from __future__ import annotations

_LATER = ("repro.serving.engine ({name}) decodes with the model zoo, which "
          "is ROADMAP A, slice 16; it is not ported to repro_torch yet — "
          "rerank candidate embeddings with repro_torch.serving."
          "OnlineReranker or rerank_batched")


class ServingEngine:
    """Not ported: ROADMAP A, slice 16."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_LATER.format(name="ServingEngine"))


def diverse_rerank(*args, **kwargs):
    """Not ported: ROADMAP A, slice 16."""
    raise NotImplementedError(_LATER.format(name="diverse_rerank"))
