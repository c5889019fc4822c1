"""``repro_torch.obs`` — structured tracing, counters and exporters (port
of ``repro.obs``).

The facade (``repro_torch.diversify``) creates a ``RunTrace`` per run and
the engines (``core.gmm``, ``core.adaptive``) report spans and counters to
whichever trace is *active*.  Tracing is off by default
(``ExecutionSpec(trace=False)``; phase wall-clocks are always recorded) and
switched on per run with ``ExecutionSpec(trace=True)`` or with
``REPRO_TRACE=1``.  ``to_jsonl``, ``to_chrome_trace`` /
``write_chrome_trace`` and ``summary_markdown`` export a finished trace.
"""
from .export import (summary_markdown, to_chrome_trace, to_jsonl,
                     write_chrome_trace)
from .trace import (COUNTER_NAMES, ENV_VAR, RunTrace, Span, activate, active,
                    count, counting, launch_span, reducer_detail, span,
                    sweep_bytes, trace_from_spec)

__all__ = [
    "RunTrace", "Span", "COUNTER_NAMES", "ENV_VAR",
    "activate", "active", "count", "counting", "span", "launch_span",
    "reducer_detail",
    "sweep_bytes", "trace_from_spec", "to_jsonl", "to_chrome_trace",
    "write_chrome_trace", "summary_markdown",
]
