"""The port's trace exporters (``repro_torch.obs.export``) against the
reference's (``repro.obs.export``) on equivalent traces: the same phases,
span tree, counters and extras with the same clock readings give the same
JSON lines, Chrome trace document and markdown, character for character.
A traced run of the port's facade exports through all four."""
import json

import numpy as np
import pytest

from repro.obs import export as ref_export
from repro.obs import trace as ref_trace
from repro_torch import obs as port_obs
from repro_torch.obs import trace as port_trace


def _build(mod, enabled=True, spans=True, counters=True):
    """One trace of module ``mod`` with fixed clock readings."""
    tr = mod.RunTrace(enabled=enabled)
    tr.t_start = 100.0
    tr.phases = [{"name": "coreset", "seconds": 0.25},
                 {"name": "solve", "seconds": 0.125},
                 {"name": "value", "seconds": 0.0625}]
    if spans:
        root = mod.Span("coreset", 100.0, {"k": 4})
        root.t1 = 100.25
        child = mod.Span("mr.round1", 100.0625,
                         {"reducers": 4, "schedule": [[1, 16]]})
        child.t1 = 100.1875
        for i in range(2):
            leaf = mod.Span(f"mr.reducer[{i}]", 100.0625 + i / 16,
                            {"reducer": i})
            leaf.t1 = leaf.t0 + 0.03125
            child.children.append(leaf)
        root.children.append(child)
        solve = mod.Span("solve", 100.25)
        solve.t1 = 100.375
        tr.spans = [root, solve]
    if counters:
        tr.counters.update({"distance_evals": 123456, "host_syncs": 7,
                            "device_dispatches": 3})
    tr.extras.update(mode="mapreduce", coreset_size=64,
                     resilience={"retries": 1})
    return tr


CASES = [dict(), dict(spans=False), dict(counters=False),
         dict(enabled=False, spans=False, counters=False)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_jsonl_equals_reference(case):
    kw = CASES[case]
    got = port_obs.to_jsonl(_build(port_trace, **kw))
    assert got == ref_export.to_jsonl(_build(ref_trace, **kw))
    rows = [json.loads(line) for line in got.splitlines()]
    assert rows[0]["type"] == "meta"


@pytest.mark.parametrize("case", range(len(CASES)))
def test_chrome_trace_equals_reference(case, tmp_path):
    kw = CASES[case]
    got = port_obs.to_chrome_trace(_build(port_trace, **kw))
    assert got == ref_export.to_chrome_trace(_build(ref_trace, **kw))
    path = port_obs.write_chrome_trace(_build(port_trace, **kw),
                                       str(tmp_path / "p.json"))
    ref_export.write_chrome_trace(_build(ref_trace, **kw),
                                  str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    assert json.loads(open(path).read())["displayTimeUnit"] == "ms"


@pytest.mark.parametrize("title", [None, "MapReduce (i)"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_summary_markdown_equals_reference(case, title):
    kw = CASES[case]
    assert port_obs.summary_markdown(_build(port_trace, **kw), title) == \
        ref_export.summary_markdown(_build(ref_trace, **kw), title)


def test_a_traced_port_run_exports():
    import repro_torch

    pts = np.random.default_rng(0).normal(size=(400, 3)).astype(np.float32)
    res = repro_torch.diversify(pts, k=4, execution=repro_torch.ExecutionSpec(
        device="cpu", mode="mapreduce", num_reducers=4, kprime=16, b=1,
        trace="reducers"))
    tr = res.telemetry
    lines = [json.loads(x) for x in port_obs.to_jsonl(tr).splitlines()]
    spans = [r["name"] for r in lines if r["type"] == "span"]
    assert spans[:1] == ["rounds"] and "mr.round1" in spans
    assert [s for s in spans if s.startswith("mr.reducer")] == [
        f"mr.reducer[{i}]" for i in range(4)]
    doc = port_obs.to_chrome_trace(tr)
    names = [e["name"] for e in doc["traceEvents"]]
    assert names[0] == "rounds" and names[-1] == "counters"
    assert all(e["dur"] >= 0 for e in doc["traceEvents"] if e["ph"] == "X")
    md = port_obs.summary_markdown(tr, "run")
    assert md.startswith("### run\n") and "| rounds |" in md
    assert "| distance_evals |" in md
