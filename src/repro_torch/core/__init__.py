"""Core library of the port: the batch and streaming, unconstrained engines
in PyTorch.

MapReduce (``distributed``, ``afz``) and the legacy ``diversity_maximize``
wrapper are later slices (see ROADMAP.md).
"""
from .adaptive import (AdaptiveGMMResult, RadiusCertificate, auto_kprime,
                       gmm_adaptive)
from .coreset import (Coreset, GeneralizedCoreset, build_coreset,
                      coreset_from_points)
from .gmm import (GMMExtResult, GMMResult, ScheduleResult, effective_block,
                  gmm, gmm_batched, gmm_ext, gmm_gen, gmm_schedule,
                  schedule_sweep_counts, validate_schedule)
from .measures import (MEASURES, NEEDS_INJECTIVE, brute_force_opt, diversity,
                       diversity_of_subset)
from .metrics import Metric, get_metric, register_metric
from .sequential import SEQ_ALPHA, solve, solve_on_coreset
from .smm import SMMState, StreamingCoreset

__all__ = [
    "Coreset", "GeneralizedCoreset", "build_coreset", "coreset_from_points",
    "GMMResult", "GMMExtResult", "ScheduleResult",
    "effective_block", "gmm", "gmm_batched", "gmm_ext", "gmm_gen",
    "gmm_schedule", "schedule_sweep_counts", "validate_schedule",
    "AdaptiveGMMResult", "RadiusCertificate", "auto_kprime", "gmm_adaptive",
    "MEASURES", "NEEDS_INJECTIVE", "brute_force_opt", "diversity",
    "diversity_of_subset", "Metric", "get_metric", "register_metric",
    "SEQ_ALPHA", "solve", "solve_on_coreset", "SMMState", "StreamingCoreset",
]
