"""Diversity maximization in bounded doubling dimension — PyTorch/CUDA port.

The port of the JAX package ``repro``, placed beside it.  It imports
``torch``, numpy and the standard library only — never ``jax`` nor
anything of ``repro``.  The front door is
``repro_torch.diversify(ProblemSpec, ExecutionSpec)``; its sweeps run the
hand-written CUDA kernels of ``repro_torch.kernels`` on the card (the
default device) and a plain torch version on the CPU.  Ported so far: the batch,
streaming, MapReduce (simulated, and on a ``torch.distributed`` mesh),
serving and dynamic paths, unconstrained and constrained
(``repro_torch.constrained``), with checkpoints and resilience
(``repro_torch.checkpoint``, ``repro_torch.distributed``); see ROADMAP.md
for the rest.
"""

_API = ("diversify", "plan", "ProblemSpec", "ExecutionSpec", "Plan",
        "DiversityResult")
# ``ExecutionSpec(resilience=repro_torch.ResiliencePolicy(...))`` spelling
_RESILIENCE = ("ResiliencePolicy", "FailureInjector")
# ``repro_torch.diversify([repro_torch.Insert(...), ...])`` spelling
_DYNAMIC = ("DynamicIndex", "RebuildPolicy", "Insert", "Delete")

__all__ = list(_API) + list(_RESILIENCE) + list(_DYNAMIC)


def __getattr__(name):
    # lazy: `import repro_torch` stays light; the facade loads on first use
    if name in _API:
        from repro_torch import api
        return getattr(api, name)
    if name in _RESILIENCE:
        from repro_torch.distributed import fault_tolerance
        return getattr(fault_tolerance, name)
    if name in _DYNAMIC:
        from repro_torch import dynamic
        return getattr(dynamic, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
