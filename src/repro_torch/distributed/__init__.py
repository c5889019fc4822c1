"""Resilience of the port's runs (port of ``repro.distributed``'s
``fault_tolerance``).  The gradient compression and pipeline helpers of the
reference package are ROADMAP A, slice 15."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              ResiliencePolicy, ResilienceReport,
                              StragglerPolicy, SupervisorReport,
                              TrainingSupervisor, degraded_certificate,
                              retry_call, run_resilient, run_unit)

__all__ = ["FailureInjector", "InjectedFailure", "ResiliencePolicy",
           "ResilienceReport", "StragglerPolicy", "SupervisorReport",
           "TrainingSupervisor", "degraded_certificate", "retry_call",
           "run_resilient", "run_unit"]
