"""Resilience of the port's runs (port of ``repro.distributed``'s
``fault_tolerance``).  The gradient compression and pipeline helpers of the
reference package serve its training loop: ROADMAP A, slice 16b (dense
training)."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              ResiliencePolicy, ResilienceReport,
                              StragglerPolicy, SupervisorReport,
                              TrainingSupervisor, degraded_certificate,
                              retry_call, run_resilient, run_unit)

__all__ = ["FailureInjector", "InjectedFailure", "ResiliencePolicy",
           "ResilienceReport", "StragglerPolicy", "SupervisorReport",
           "TrainingSupervisor", "degraded_certificate", "retry_call",
           "run_resilient", "run_unit"]
