"""End-to-end parity of the port's streaming facade: ``repro_torch.diversify``
on a chunk iterator, with ``mode="streaming"`` and with
``memory_budget_bytes``, against ``repro.diversify`` on the same numpy
chunks.

The port runs on the CPU (``device="cpu"``, its plain torch path).  The
solution, ``indices``, the certificate's counts and ``meets_target``, the
telemetry keys and the ``explain()`` text must be equal; the value to rtol
1e-4 (the reference's end-to-end parity) and the certificate's radius,
scale and ratio to rtol 1e-5 (d_i starts as the smallest positive pairwise
distance, where a 1-ulp difference of an fp32 dot product summed in
another order is amplified; see tests/test_torch_smm.py).
"""
import numpy as np
import pytest

import repro
import repro_torch
from repro_torch.interop import from_reference

RTOL_VALUE = 1e-4
RTOL_CERT = 1e-5
STREAM_KEYS = {"mode", "n_seen", "merges", "coreset_size"}


def _points(n=2400, d=4, seed=0):
    rg = np.random.default_rng(seed)
    scale = 1.0 + np.arange(n)[:, None] / 400.0
    return (rg.normal(size=(n, d)) * scale).astype(np.float32)


def _chunks(pts, size=300):
    return (pts[i:i + size] for i in range(0, len(pts), size))


def _both(source, k, measure="remote-edge", metric="euclidean", **kw):
    want = repro.diversify(source(), k=k, measure=measure, metric=metric,
                           execution=repro.ExecutionSpec(**kw))
    got = repro_torch.diversify(source(), k=k, measure=measure,
                                metric=metric,
                                execution=repro_torch.ExecutionSpec(
                                    device="cpu", **kw))
    return want, got


def assert_result_equal(got, want):
    np.testing.assert_array_equal(got.solution, np.asarray(want.solution))
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL_VALUE)
    if want.indices is None:
        assert got.indices is None
    else:
        np.testing.assert_array_equal(got.indices, want.indices)
    gc, wc = got.cert, from_reference(want.cert)
    assert (gc.kind, gc.kprime, gc.counts, gc.meets_target) == \
        (wc.kind, wc.kprime, wc.counts, wc.meets_target)
    for f in ("radius", "scale", "ratio"):
        np.testing.assert_allclose(getattr(gc, f), getattr(wc, f),
                                   rtol=RTOL_CERT, err_msg=f)
    np.testing.assert_allclose(gc.radii, wc.radii, rtol=RTOL_CERT)
    assert got.telemetry.extras == want.telemetry.extras
    assert set(got.telemetry.extras) >= STREAM_KEYS
    assert [p["name"] for p in got.telemetry.phases] == \
        [p["name"] for p in want.telemetry.phases] == \
        ["stream", "finalize", "solve", "value"]
    assert got.plan.explain() == want.plan.explain()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique",
                                     "remote-star", "remote-tree"])
def test_chunk_iterator(measure, metric):
    pts = _points()
    want, got = _both(lambda: _chunks(pts), 5, measure, metric, kprime=20)
    assert got.plan.mode == "streaming"
    assert got.plan.reason == "auto: chunk-iterator input"
    assert got.indices is None                # a stream keeps no rows
    assert_result_equal(got, want)


def test_generalized_stream():
    pts = _points(seed=1)
    want, got = _both(lambda: _chunks(pts, 256), 6, "remote-clique",
                      smm_mode="gen", kprime=24, eps=0.5)
    assert got.plan.variant == "gen"
    assert_result_equal(got, want)


def test_mode_streaming_on_an_array():
    pts = _points(seed=2)
    want, got = _both(lambda: pts, 5, "remote-edge", mode="streaming",
                      chunk=512)
    assert got.plan.mode == "streaming" and got.plan.reason == "requested"
    assert len(got.indices) == 5
    np.testing.assert_array_equal(pts[got.indices], got.solution)
    assert_result_equal(got, want)


def test_memory_budget_switches_to_streaming():
    pts = _points(seed=3)
    want, got = _both(lambda: pts, 4, "remote-cycle",
                      memory_budget_bytes=pts.nbytes - 1, chunk=700)
    assert got.plan.mode == "streaming"
    assert got.plan.reason.startswith("auto: input ")
    assert_result_equal(got, want)
    # within the budget it stays batch
    p = repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=4),
                         repro_torch.ExecutionSpec(
                             memory_budget_bytes=pts.nbytes, device="cpu"))
    assert p.mode == "batch"


def test_plan_knobs_and_explain_match_reference():
    pts = _points(n=100, d=3)
    for kw in ({}, {"kprime": 40, "chunk": 64}, {"smm_mode": "ext"},
               {"generalized": True}):
        src = [pts[:50], pts[50:]]
        want = repro.plan(repro.ProblemSpec(points=iter(src), k=3, dim=3),
                          repro.ExecutionSpec(**kw))
        got = repro_torch.plan(repro_torch.ProblemSpec(points=iter(src), k=3,
                                                       dim=3),
                               repro_torch.ExecutionSpec(device="cpu", **kw))
        assert (got.mode, got.variant, got.knobs["kprime"],
                got.knobs["chunk"], got.coreset_rows, got.coreset_bytes) == \
            (want.mode, want.variant, want.knobs["kprime"],
             want.knobs["chunk"], want.coreset_rows, want.coreset_bytes)
        assert got.explain() == want.explain()


def test_trace_counts_stream_work():
    pts = _points(seed=4)
    want, got = _both(lambda: _chunks(pts), 5, kprime=20, trace=True)
    for name in ("points_absorbed", "merges"):
        assert got.telemetry.counters[name] == \
            want.telemetry.counters[name], name
    assert got.telemetry.counters["points_absorbed"] == len(pts)


def test_not_ported_and_rejected():
    pts = _points(n=200)
    ex = repro_torch.ExecutionSpec

    def plan(source, **kw):
        return repro_torch.plan(source, ex(device="cpu", **kw))

    spec = repro_torch.ProblemSpec(points=iter([pts]), k=3)
    with pytest.raises(NotImplementedError, match="slice 12"):
        plan(spec, resilience=object())
    with pytest.raises(NotImplementedError, match="slice 12"):
        plan(repro_torch.ProblemSpec(points=pts, k=3), mode="streaming",
             resilience=object())
    with pytest.raises(NotImplementedError, match="slice 11"):
        plan(repro_torch.ProblemSpec(points=iter([pts]), k=3,
                                     quotas=[1, 2]))
    with pytest.raises(ValueError, match="only supports mode='streaming'"):
        plan(spec, mode="batch")
    with pytest.raises(ValueError, match="true metric"):
        plan(repro_torch.ProblemSpec(points=iter([pts]), k=3,
                                     metric="sqeuclidean"))
    with pytest.raises(ValueError, match="batch-only"):
        plan(repro_torch.ProblemSpec(points=pts, k=3,
                                     weights=np.ones(200)),
             mode="streaming")
    with pytest.raises(ValueError, match="empty stream"):
        repro_torch.diversify(iter([]), k=3, execution=ex(device="cpu"))
