"""RunTrace exporters: JSON-lines, Chrome ``trace_event`` and markdown
(port of ``repro.obs.export``).

Three consumers, three formats:

* ``to_jsonl`` — one self-describing JSON object per line (meta, counters,
  phases, then every span depth-first) for log shippers and ad-hoc ``jq``;
* ``to_chrome_trace`` — the Chrome ``trace_event`` JSON (complete "X"
  events, microsecond timestamps) loadable in Perfetto / ``chrome://tracing``
  next to a device profile (``torch.profiler``'s export);
* ``summary_markdown`` — the human-readable table CI drops into the job
  summary.
"""
from __future__ import annotations

import json
from typing import List, Optional

from .trace import RunTrace, Span


def _span_rows(spans, depth: int = 0):
    for s in spans:
        yield s, depth
        yield from _span_rows(s.children, depth + 1)


def to_jsonl(trace: RunTrace) -> str:
    """One JSON object per line: meta, counters, each phase, each span."""
    lines = [json.dumps({"type": "meta", "enabled": trace.enabled,
                         **trace.extras})]
    if trace.counters:
        lines.append(json.dumps({"type": "counters", **trace.counters}))
    for p in trace.phases:
        lines.append(json.dumps({"type": "phase", **p}))
    for s, depth in _span_rows(trace.spans):
        row = {"type": "span", "depth": depth, **s.to_dict()}
        row.pop("children", None)
        lines.append(json.dumps(row))
    return "\n".join(lines) + "\n"


def to_chrome_trace(trace: RunTrace) -> dict:
    """Chrome ``trace_event`` document (Perfetto-loadable).

    Spans become complete ("X") events on one thread; counters become a
    single counter ("C") sample at the end of the run; timestamps are
    microseconds relative to the trace start.
    """
    t0 = trace.t_start
    events: List[dict] = []

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    def emit(span: Span):
        ev = {"name": span.name, "ph": "X", "ts": us(span.t0),
              "dur": round(span.seconds * 1e6, 3), "pid": 0, "tid": 0,
              "cat": "repro"}
        if span.attrs:
            ev["args"] = {k: str(v) for k, v in span.attrs.items()}
        events.append(ev)
        for c in span.children:
            emit(c)

    if trace.spans:
        for s in trace.spans:
            emit(s)
    else:
        # disabled trace: synthesize contiguous phase events
        cursor = 0.0
        for p in trace.phases:
            events.append({"name": p["name"], "ph": "X",
                           "ts": round(cursor * 1e6, 3),
                           "dur": round(p["seconds"] * 1e6, 3),
                           "pid": 0, "tid": 0, "cat": "repro"})
            cursor += p["seconds"]
    if trace.counters:
        end = max((e["ts"] + e["dur"] for e in events), default=0.0)
        events.append({"name": "counters", "ph": "C", "ts": end,
                       "pid": 0, "tid": 0,
                       "args": dict(trace.counters)})
    meta = {k: str(v) for k, v in trace.extras.items()}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(trace: RunTrace, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(trace), f, indent=1)
    return path


def summary_markdown(trace: RunTrace, title: Optional[str] = None) -> str:
    """Markdown summary: phase table + counter table."""
    lines = []
    if title:
        lines += [f"### {title}", ""]
    mode = trace.extras.get("mode")
    if mode:
        lines += [f"mode: `{mode}`", ""]
    total = trace.total_seconds()
    lines += ["| phase | seconds | share |", "|---|---:|---:|"]
    for p in trace.phases:
        share = p["seconds"] / total if total > 0 else 0.0
        lines.append(f"| {p['name']} | {p['seconds']:.4f} | {share:.0%} |")
    lines.append(f"| **total** | **{total:.4f}** | |")
    if trace.counters:
        lines += ["", "| counter | value |", "|---|---:|"]
        for k in sorted(trace.counters):
            lines.append(f"| {k} | {trace.counters[k]:,} |")
    return "\n".join(lines) + "\n"
