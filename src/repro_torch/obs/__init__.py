"""``repro_torch.obs`` — structured tracing + counters (port of
``repro.obs``; the exporters wait for a later slice).

The facade (``repro_torch.diversify``) creates a ``RunTrace`` per run and
the engines (``core.gmm``, ``core.adaptive``) report spans and counters to
whichever trace is *active*.  Tracing is off by default
(``ExecutionSpec(trace=False)``; phase wall-clocks are always recorded) and
switched on per run with ``ExecutionSpec(trace=True)`` or with
``REPRO_TRACE=1``.
"""
from .trace import (COUNTER_NAMES, ENV_VAR, RunTrace, Span, activate, active,
                    count, counting, reducer_detail, span, sweep_bytes,
                    trace_from_spec)

__all__ = [
    "RunTrace", "Span", "COUNTER_NAMES", "ENV_VAR",
    "activate", "active", "count", "counting", "span", "reducer_detail",
    "sweep_bytes", "trace_from_spec",
]
