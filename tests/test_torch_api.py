"""End-to-end parity of the port's facade: ``repro_torch.diversify`` against
``repro.diversify`` on the README quickstart shapes, every measure, the
generalized and weighted inputs, and ``plan().explain()`` text.

The port runs on the CPU (``device="cpu"``, its plain torch path); the
reference on its lax path.  Indices, executed schedules, counts and
meets_target must be equal; values and certificate radii agree to rtol
1e-5 (fp32 dot products are summed in another order by XLA and by torch).
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.interop import from_reference, to_numpy

RTOL = 1e-5


def _ex(**kw):
    return repro.ExecutionSpec(**kw), repro_torch.ExecutionSpec(device="cpu",
                                                                **kw)


def _both(pts, k, measure="remote-edge", metric="euclidean", **kw):
    rex, pex = _ex(**kw)
    want = repro.diversify(pts, k=k, measure=measure, metric=metric,
                           execution=rex)
    got = repro_torch.diversify(pts, k=k, measure=measure, metric=metric,
                                execution=pex)
    return want, got


def assert_cert_close(got, want):
    if want is None:
        assert got is None
        return
    assert got.kprime == want.kprime and got.counts == want.counts
    assert got.b_schedule == want.b_schedule
    assert got.meets_target == want.meets_target
    for f in ("radius", "scale", "ratio"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_allclose(got.radii, want.radii, rtol=RTOL)


def test_quickstart_default_call():
    # README "30-second quickstart": planner picks batch + auto knobs
    emb = np.random.default_rng(0).normal(size=(5000, 32)).astype(np.float32)
    want, got = _both(emb, 16)
    assert got.solution.shape == (16, 32)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert_cert_close(got.cert, from_reference(want.cert))
    assert got.plan.explain() == want.plan.explain()


def test_quickstart_auto_engine_meets_eps():
    # README "The engine tunes itself by default"
    pts = np.random.default_rng(0).normal(size=(4000, 2)).astype(np.float32)
    want, got = _both(pts, 6, eps=0.5)
    assert got.cert.meets_target
    assert list(got.cert.radii) == sorted(got.cert.radii, reverse=True)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert_cert_close(got.cert, want.cert)


def test_quickstart_trace_counts_exact_work():
    # README "Trace any run": distance_evals == n * k' for exact b=1 GMM
    pts = np.random.default_rng(0).normal(size=(2048, 8)).astype(np.float32)
    want, got = _both(pts, 8, mode="batch", kprime=32, b=1, trace=True)
    tr = got.telemetry
    assert tr.counters["distance_evals"] == 2048 * 32
    assert tr.counters["host_syncs"] == 0
    # jit_recompiles has no counterpart in the eager port (stays 0)
    ref_counters = dict(want.telemetry.counters)
    ref_counters.pop("jit_recompiles", None)
    assert dict(tr.counters) == ref_counters
    assert [p["name"] for p in tr["phases"]] == ["coreset", "solve", "value"]
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    text = got.plan.explain(actual=True)
    assert "measured:" in text and "distance_evals=65,536" in text


def test_adaptive_trace_counters_match_reference():
    pts = np.random.default_rng(1).normal(size=(3000, 4)).astype(np.float32)
    want, got = _both(pts, 4, kprime=64, b="auto", sprint=False, trace=True)
    for key in ("distance_evals", "bytes_swept", "host_syncs",
                "device_dispatches"):
        assert got.telemetry.counters[key] == want.telemetry.counters[key]
    assert_cert_close(got.cert, want.cert)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique",
                                     "remote-star", "remote-bipartition",
                                     "remote-tree", "remote-cycle"])
def test_every_measure_at_pinned_kprime(measure):
    pts = np.random.default_rng(7).normal(size=(400, 3)).astype(np.float32)
    want, got = _both(pts, 5, measure=measure, kprime=16, b=1)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert got.plan.variant == want.plan.variant
    assert got.coreset.size == want.coreset.size


@pytest.mark.parametrize("metric", ["cosine", "manhattan"])
def test_metrics_end_to_end(metric):
    pts = np.random.default_rng(8).normal(size=(1500, 6)).astype(np.float32)
    want, got = _both(pts, 6, metric=metric, kprime=48)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert_cert_close(got.cert, want.cert)


def test_generalized_and_weighted_inputs():
    pts = np.random.default_rng(9).normal(size=(600, 3)).astype(np.float32)
    want, got = _both(pts, 5, measure="remote-clique", kprime=16, b=1,
                      generalized=True)
    assert got.indices is None and want.indices is None
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    cs = to_numpy(got.coreset)
    np.testing.assert_array_equal(cs["multiplicity"],
                                  np.asarray(want.coreset.multiplicity))
    w = np.random.default_rng(2).integers(1, 4, size=40)
    small = pts[:40]
    want = repro.diversify(small, k=6, measure="remote-star", weights=w)
    got = repro_torch.diversify(small, k=6, measure="remote-star", weights=w,
                                execution=repro_torch.ExecutionSpec(
                                    device="cpu"))
    np.testing.assert_allclose(got.solution, want.solution)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)


@pytest.mark.parametrize("spec", [
    dict(kprime=64, b=4, chunk=1024, mode="batch"),
    dict(),
    dict(eps=0.3, sprint=False),
    dict(kprime=None, b=1),
    dict(generalized=True, kprime=48),
])
@pytest.mark.parametrize("measure", ["remote-edge", "remote-tree"])
def test_explain_text_identical(spec, measure):
    pts = np.zeros((4096, 8), np.float32)
    rex, pex = _ex(**spec)
    want = repro.plan(repro.ProblemSpec(points=pts, k=8, measure=measure),
                      rex)
    got = repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=8,
                                                   measure=measure), pex)
    assert got.explain() == want.explain()
    assert got.mode == want.mode and got.variant == want.variant


def test_tensor_points_stay_on_their_device():
    pts = torch.randn(500, 4, generator=torch.Generator().manual_seed(0))
    res = repro_torch.diversify(pts, k=4, execution=repro_torch.ExecutionSpec(
        device="cpu", kprime=16, b=1))
    assert res.coreset.points.device.type == "cpu"
    assert len(set(res.indices.tolist())) == 4
    np.testing.assert_array_equal(pts.numpy()[res.indices], res.solution)


@pytest.mark.parametrize("kind", ["streaming", "mapreduce", "serving",
                                  "dynamic", "constrained", "budget",
                                  "reducers"])
def test_unported_modes_raise_with_their_slice(kind):
    pts = np.zeros((64, 4), np.float32)
    ex, prob = {}, dict(points=pts, k=4)
    if kind in ("mapreduce", "serving", "dynamic"):
        ex["mode"] = kind
    elif kind in ("streaming", "budget"):
        # streaming itself is ported (slice 9); resilience= on a stream is
        # the part still to come (slice 12)
        ex["resilience"] = object()
        if kind == "streaming":
            ex["mode"] = "streaming"
        else:
            ex["memory_budget_bytes"] = 16
    elif kind == "constrained":
        prob["labels"] = np.zeros(64, int)
    else:
        ex["num_reducers"] = 4
    with pytest.raises(NotImplementedError, match="ROADMAP A, slice"):
        repro_torch.plan(repro_torch.ProblemSpec(**prob),
                         repro_torch.ExecutionSpec(device="cpu", **ex))
    # a constrained stream names the constrained slice
    with pytest.raises(NotImplementedError, match="slice 11"):
        repro_torch.plan(repro_torch.ProblemSpec(points=iter([pts]), k=4,
                                                 quotas=[2, 2]),
                         repro_torch.ExecutionSpec(device="cpu"))


def test_from_reference_round_trip():
    pts = np.random.default_rng(3).normal(size=(800, 3)).astype(np.float32)
    want, got = _both(pts, 4, kprime=32)
    ported = from_reference(want)
    np.testing.assert_array_equal(ported.indices, got.indices)
    assert_cert_close(got.cert, ported.cert)
    cs = from_reference(want.coreset)
    np.testing.assert_allclose(cs.points.numpy(), to_numpy(got.coreset.points),
                               rtol=RTOL)
