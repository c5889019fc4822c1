"""RunTrace — spans and counters of one execution (port of
``repro.obs.trace``).

* a ``RunTrace`` holds nested ``Span``s (phase -> sweep -> block) and
  monotonic counters (``distance_evals``, ``bytes_swept``, ``host_syncs``,
  ...);
* an optional ``sync=`` target fences a span: when it holds a CUDA tensor,
  ``torch.cuda.synchronize()`` runs before the clock is read, so spans
  measure execution and not the asynchronous launch; enabled spans open a
  ``torch.profiler.record_function`` range so they line up with device
  profiles;
* instrumented call-sites talk to the *active* trace through module-level
  ``count()`` / ``span()`` / ``counting()`` — with no enabled trace active
  these are one global load and an ``is None`` test.

``jit_recompiles`` has no counterpart in the port: PyTorch runs eagerly and
compiles nothing per shape, so the counter exists and stays 0.  The
exporters are ``obs.export``.

``RunTrace`` is also a ``Mapping`` so the legacy telemetry dict contract
(``res.telemetry["phases"]`` -> ``[{"name", "seconds"}, ...]``) holds.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import torch

# Counter glossary: the reference's (repro/obs/trace.py), same names.
COUNTER_NAMES = ("distance_evals", "bytes_swept", "host_syncs",
                 "device_dispatches", "pool_widenings", "sprint_segments",
                 "jit_recompiles", "points_absorbed", "merges", "retries",
                 "failures_injected", "checkpoints_written",
                 "reducers_recovered", "sessions_active", "rerank_batched",
                 "coreset_reuses", "inserts_absorbed", "deletes_absorbed",
                 "level_rebuilds")

ENV_VAR = "REPRO_TRACE"


def sweep_bytes(n: int, d: int, sweeps: int = 1, m: int = 1) -> int:
    """Modeled traffic of ``sweeps`` field sweeps: point slab (n*d fp32) read
    once plus m running-min fields read+written (+mask) per sweep — the
    reference's model, kept so the counters compare."""
    return sweeps * (n * d * 4 + 3 * m * n * 4)


def _has_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_has_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_has_cuda(v) for v in x.values())
    return False


def _block(x) -> None:
    """Fence: wait for the device when ``x`` holds a CUDA tensor."""
    if x is not None and _has_cuda(x):
        torch.cuda.synchronize()


class Span:
    """One timed region.  ``seconds`` is wall-clock between enter and exit,
    with the exit fenced on ``sync`` when one was given."""
    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, t0: float, attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs or {}
        self.children: List["Span"] = []

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        out = {"name": self.name, "seconds": self.seconds}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class _SpanCtx:
    """Context manager for one enabled span (profiler-annotated)."""
    __slots__ = ("_trace", "_span", "_sync", "_rf")

    def __init__(self, trace: "RunTrace", name: str, sync, attrs):
        self._trace = trace
        self._span = Span(name, 0.0, attrs)
        self._sync = sync
        self._rf = None

    def __enter__(self) -> Span:
        self._rf = torch.profiler.record_function(self._span.name)
        self._rf.__enter__()
        self._trace._push(self._span)
        self._span.t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc):
        _block(self._sync)
        self._span.t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        self._trace._pop(self._span)
        return False


class _NullSpanCtx:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCtx()


class RunTrace(Mapping):
    """Spans + counters of one execution, with a legacy-compatible dict view.

    ``enabled=False`` records only the top-level phase rows and the extras
    the run paths annotate (``mode``, ``coreset_size``, ...);
    ``enabled=True`` additionally activates the counters, nested spans and
    profiler annotations.  ``reducers=True`` (``trace="reducers"``) also
    asks a simulated MapReduce run for one ``mr.reducer[i]`` span per
    reducer.
    """

    def __init__(self, enabled: bool = False, reducers: bool = False):
        self.enabled = bool(enabled) or bool(reducers)
        self.reducers = bool(reducers)
        self.phases: List[dict] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.spans: List[Span] = []
        self.extras: Dict[str, Any] = {}
        self.t_start = time.perf_counter()
        self._stack: List[Span] = []

    # -- recording ---------------------------------------------------------
    def phase(self, name: str, t0: float, sync=None) -> float:
        """Close phase ``name`` opened at ``t0``: fence ``sync`` so the row
        measures execution (not the asynchronous launch), record, return
        the fenced now (= the next phase's t0)."""
        _block(sync)
        t1 = time.perf_counter()
        self.phases.append({"name": name, "seconds": t1 - t0})
        if self.enabled:
            sp = Span(name, t0)
            sp.t1 = t1
            root, keep = [], []
            for s in self.spans:
                (root if s.t0 >= t0 else keep).append(s)
            sp.children = root
            self.spans = keep + [sp]
        return t1

    def span(self, name: str, sync=None, **attrs):
        """Nested span context manager (no-op unless enabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, sync, attrs or None)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counters[name] += n

    def annotate(self, **extras) -> "RunTrace":
        """Attach per-mode extras (``mode``, ``coreset_size``, ...)."""
        self.extras.update(extras)
        return self

    def _push(self, span: Span) -> None:
        if self._stack:
            self._stack[-1].children.append(span)
        else:
            self.spans.append(span)
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        if self._stack and self._stack[-1] is span:
            self._stack.pop()

    # -- views -------------------------------------------------------------
    def as_dict(self) -> dict:
        """The legacy telemetry dict view (plus ``counters`` when enabled)."""
        out: Dict[str, Any] = {"phases": list(self.phases)}
        out.update(self.extras)
        if self.enabled:
            out["counters"] = dict(self.counters)
        return out

    def total_seconds(self) -> float:
        return sum(p["seconds"] for p in self.phases)

    def __getitem__(self, key):
        return self.as_dict()[key]

    def __iter__(self):
        return iter(self.as_dict())

    def __len__(self):
        return len(self.as_dict())

    def __repr__(self):
        cs = ", ".join(f"{k}={v}" for k, v in sorted(self.counters.items()))
        ph = ", ".join(f"{p['name']}={p['seconds']:.3g}s" for p in self.phases)
        return (f"RunTrace(enabled={self.enabled}, phases=[{ph}]"
                + (f", counters=[{cs}]" if cs else "") + ")")


# --------------------------------------------------------------------------
# the active trace (module-global; the disabled fast path is one load+test)
# --------------------------------------------------------------------------

_ACTIVE: Optional[RunTrace] = None


def active() -> Optional[RunTrace]:
    """The trace instrumented call-sites report to (None = disabled)."""
    return _ACTIVE


def counting() -> bool:
    """True when an enabled trace is active — hot loops hoist this check."""
    t = _ACTIVE
    return t is not None and t.enabled


def count(name: str, n: int = 1) -> None:
    """Bump counter ``name`` on the active trace; no-op when disabled."""
    t = _ACTIVE
    if t is not None and t.enabled:
        t.counters[name] += n


def span(name: str, sync=None, **attrs):
    """Open a nested span on the active trace (no-op when disabled)."""
    t = _ACTIVE
    if t is None or not t.enabled:
        return _NULL_SPAN
    return _SpanCtx(t, name, sync, attrs or None)


@contextlib.contextmanager
def launch_span(name: str, launches, **attrs):
    """A span that also records, on exit, how far each count of the mapping
    ``launches`` (``kernels.build.LAUNCHES``) moved inside it, as its
    ``launches`` attribute; the exit waits for the card, so the span times
    the work.  A no-op unless an enabled trace is active."""
    with span(name, **attrs) as sp:
        before = dict(launches)
        yield sp
        if sp is not None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            sp.attrs["launches"] = {k: v - before.get(k, 0)
                                    for k, v in launches.items()}


def reducer_detail() -> bool:
    """True when the active trace asked for per-reducer spans."""
    t = _ACTIVE
    return t is not None and t.reducers


@contextlib.contextmanager
def activate(trace: Optional[RunTrace]):
    """Make ``trace`` the active trace for the enclosed block (re-entrant:
    the previous active trace is restored)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = trace
    try:
        yield trace
    finally:
        _ACTIVE = prev


def trace_from_spec(knob) -> RunTrace:
    """Resolve the ``ExecutionSpec(trace=...)`` knob (or the ``REPRO_TRACE``
    env var when ``"auto"``) into a ``RunTrace``.  Accepted values: ``False``
    / ``True`` / ``"auto"`` / ``"reducers"`` / an existing ``RunTrace``."""
    if isinstance(knob, RunTrace):
        return knob
    if knob == "auto" or knob is None:
        env = os.environ.get(ENV_VAR, "").strip().lower()
        knob = ("reducers" if env == "reducers"
                else env in ("1", "true", "on", "yes"))
    if knob == "reducers":
        return RunTrace(enabled=True, reducers=True)
    return RunTrace(enabled=bool(knob))
