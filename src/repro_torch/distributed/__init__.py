"""Resilience and the data- and pipeline-parallel helpers of training
(port of ``repro.distributed``): ``fault_tolerance``, gradient
``compression`` over a ``torch.distributed`` group, the GPipe
``pipeline`` over a ``DeviceMesh`` dimension, and the collectives of the
sharded training step (``sharded``)."""
from .compression import (dequantize_int8, init_error_feedback, psum_bf16,
                          psum_int8_ef, quantize_int8)
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              ResiliencePolicy, ResilienceReport,
                              StragglerPolicy, SupervisorReport,
                              TrainingSupervisor, degraded_certificate,
                              retry_call, run_resilient, run_unit)
from .pipeline import pipeline_apply

__all__ = ["FailureInjector", "InjectedFailure", "ResiliencePolicy",
           "ResilienceReport", "StragglerPolicy", "SupervisorReport",
           "TrainingSupervisor", "degraded_certificate", "dequantize_int8",
           "init_error_feedback", "pipeline_apply", "psum_bf16",
           "psum_int8_ef", "quantize_int8", "retry_call", "run_resilient",
           "run_unit"]
