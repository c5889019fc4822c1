"""Serving-time diversity on the port (port of ``repro.serving``'s rerank
layer): the fused multi-tenant ``rerank_batched`` and the session
``OnlineReranker``.  The model-backed ``serving.engine`` is ROADMAP A,
slice 16."""
from .rerank import (GMM_PREFIX_MEASURES, BatchedRerank, OnlineReranker,
                     RerankResult, Session, SessionStore, rerank_batched,
                     session_nbytes)

__all__ = ["GMM_PREFIX_MEASURES", "BatchedRerank", "OnlineReranker",
           "RerankResult", "Session", "SessionStore", "rerank_batched",
           "session_nbytes"]
