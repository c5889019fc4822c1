"""Serving on the port (port of ``repro.serving``): the model-backed
``ServingEngine`` (prefill and greedy decode against a KV cache, then a
fused diverse rerank of each group's candidates), the legacy
``diverse_rerank``, the fused multi-tenant ``rerank_batched`` and the
session ``OnlineReranker``."""
from .engine import Request, ServingEngine, diverse_rerank
from .rerank import (GMM_PREFIX_MEASURES, BatchedRerank, OnlineReranker,
                     RerankResult, Session, SessionStore, rerank_batched,
                     session_nbytes)

__all__ = ["Request", "ServingEngine", "diverse_rerank",
           "GMM_PREFIX_MEASURES", "BatchedRerank", "OnlineReranker",
           "RerankResult", "Session", "SessionStore", "rerank_batched",
           "session_nbytes"]
