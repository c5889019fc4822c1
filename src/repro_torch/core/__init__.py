"""Core library of the port: the batch, streaming and MapReduce (simulated
and over a ``torch.distributed`` mesh, ``core.distributed``) unconstrained
engines in PyTorch, with the legacy ``diversity_maximize`` wrapper over
the facade.
"""
from .adaptive import (AdaptiveGMMResult, RadiusCertificate, auto_kprime,
                       gmm_adaptive, resolve_engine_plan)
from .coreset import (Coreset, GeneralizedCoreset, build_coreset,
                      coreset_from_points, diversity_maximize)
from .gmm import (GMMExtResult, GMMResult, ScheduleResult, effective_block,
                  gmm, gmm_batched, gmm_ext, gmm_gen, gmm_schedule,
                  schedule_sweep_counts, validate_schedule)
from .measures import (MEASURES, NEEDS_INJECTIVE, brute_force_opt, diversity,
                       diversity_of_subset)
from .metrics import Metric, get_metric, register_metric
from .sequential import SEQ_ALPHA, instantiate, solve, solve_on_coreset
from .smm import SMMState, StreamingCoreset

__all__ = [
    "Coreset", "GeneralizedCoreset", "build_coreset", "coreset_from_points",
    "diversity_maximize",
    "GMMResult", "GMMExtResult", "ScheduleResult",
    "effective_block", "gmm", "gmm_batched", "gmm_ext", "gmm_gen",
    "gmm_schedule", "schedule_sweep_counts", "validate_schedule",
    "AdaptiveGMMResult", "RadiusCertificate", "auto_kprime", "gmm_adaptive",
    "resolve_engine_plan", "MEASURES", "NEEDS_INJECTIVE", "brute_force_opt", "diversity",
    "diversity_of_subset", "Metric", "get_metric", "register_metric",
    "SEQ_ALPHA", "instantiate", "solve", "solve_on_coreset", "SMMState",
    "StreamingCoreset",
]
