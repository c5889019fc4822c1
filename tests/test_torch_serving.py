"""The port's serving layer (``repro_torch.serving``) against the
reference's (``repro.serving``) on the same seeded inputs, on the CPU.

* ``rerank_batched``: indices equal up to proven ties (where the two
  differ, both picks are equally far from the slate before them, to rtol
  1e-5); radii to rtol 1e-4; remote-edge values to rtol 1e-5.  Values of a
  measure that sums a whole distance matrix (remote-star) read its
  diagonal, the self-distances, which neither package zeroes: the
  factorized euclidean form leaves them at up to about 1e-3 on this data
  (in the reference they also differ between its jitted, vmapped matrix
  and an eager one).  Such values are held to 2 x the largest
  self-distance of either side plus rtol 1e-5 — the port's recorded
  decision (ROADMAP C, "B3 diagonal").
* ``OnlineReranker``: slates and reuse decisions equal; certificates'
  counts equal and their radius, scale and ratio to rtol 1e-5 (the SMM
  parity tests' tolerance: ``d_thr`` starts at the smallest positive
  distance, where an fp32 sum order shows); counters, LRU evictions and
  ``session_nbytes`` equal.
* sessions save and restore through either package's manager.
* the facade: ``mode="serving"``, a 3-D ``auto`` input and ``explain()``.
"""
import tempfile

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.checkpoint import CheckpointManager as RefManager
from repro.core.metrics import get_metric as ref_metric
from repro.serving import OnlineReranker as RefReranker
from repro.serving import rerank_batched as ref_rerank_batched
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.metrics import get_metric
from repro_torch.obs.trace import RunTrace, activate
from repro_torch.serving import (OnlineReranker, SessionStore,
                                 rerank_batched, session_nbytes)

RTOL = 1e-5


def _chunks(n, d, count, seed=0, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return [(offset + scale * rng.normal(size=(n, d))).astype(np.float32)
            for _ in range(count)]


def _anticover(pts, slate_idx, j, metric):
    """Distance of pick j to the picks before it (its GMM key)."""
    d = get_metric(metric).pairwise(torch.as_tensor(pts[slate_idx[j]][None]),
                                    torch.as_tensor(pts[slate_idx[:j]]))
    return float(d.min())


def assert_picks(got, want, pts, metric):
    """Equal picks, or equal up to the first proven near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    for j in range(len(want)):
        if got[j] != want[j]:
            a = _anticover(pts, got, j, metric)
            b = _anticover(pts, want, j, metric)
            assert np.isclose(a, b, rtol=RTOL), (j, a, b)
            return
    np.testing.assert_array_equal(got, want)


def _self_bound(pts, idx, metric):
    """Largest self-distance of the slate's matrix in either package."""
    sl = pts[idx]
    port = get_metric(metric).pairwise(torch.as_tensor(sl),
                                       torch.as_tensor(sl))
    ref = np.asarray(ref_metric(metric).pairwise(sl, sl))
    return max(float(torch.diagonal(port).max()), float(np.diag(ref).max()))


# -- the stateless fused rerank ----------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("measure", ["remote-edge", "remote-star",
                                     "remote-tree"])
def test_rerank_batched_3d_matches_reference(measure, metric):
    reqs = np.stack(_chunks(64, 8, 6, seed=1))
    got = rerank_batched(reqs, k=5, measure=measure, metric=metric,
                         device="cpu")
    want = ref_rerank_batched(reqs, k=5, measure=measure, metric=metric)
    assert got.indices.shape == (6, 5) and got.values.dtype == np.float64
    for r in range(6):
        assert_picks(got.indices[r], want.indices[r], reqs[r], metric)
        if (got.indices[r] != want.indices[r]).any():
            continue
        np.testing.assert_allclose(got.radii[r], want.radii[r], rtol=1e-4)
        if measure == "remote-edge":
            np.testing.assert_allclose(got.values[r], want.values[r],
                                       rtol=RTOL)
        else:
            tol = 2 * _self_bound(reqs[r], got.indices[r], metric) \
                + RTOL * abs(want.values[r])
            assert abs(got.values[r] - want.values[r]) <= tol


def test_rerank_batched_ragged_matches_reference():
    rng = np.random.default_rng(99)
    reqs = [rng.normal(size=(n, 8)).astype(np.float32)
            for n in (40, 64, 17, 23)]
    got = rerank_batched(reqs, k=4, device="cpu")
    want = ref_rerank_batched(reqs, k=4)
    for i, r in enumerate(reqs):
        assert got.indices[i].max() < len(r)
        assert len(set(got.indices[i].tolist())) == 4
        assert_picks(got.indices[i], want.indices[i], r, "euclidean")
    np.testing.assert_allclose(got.radii, want.radii, rtol=1e-4)
    np.testing.assert_allclose(got.values, want.values, rtol=RTOL)


def test_rerank_batched_one_request_equals_its_row_of_many():
    """A request alone picks what it picks among many: the grouped sweep
    and the slate product compute each request from its own rows."""
    reqs = _chunks(64, 8, 8, seed=1)
    many = rerank_batched(np.stack(reqs), k=5, device="cpu")
    for i, r in enumerate(reqs):
        one = rerank_batched(r[None], k=5, device="cpu")
        np.testing.assert_array_equal(one.indices[0], many.indices[i])
        assert one.radii[0] == many.radii[i]
        assert one.values[0] == many.values[i]


def test_rerank_batched_tensor_input_and_counters():
    reqs = torch.as_tensor(np.stack(_chunks(50, 6, 3, seed=2)))
    tr = RunTrace(enabled=True)
    with activate(tr):
        out = rerank_batched(reqs, k=4)           # the tensor's own device
    assert out.indices.shape == (3, 4)
    assert tr.counters["rerank_batched"] == 3
    assert tr.counters["device_dispatches"] == 1
    assert tr.spans[0].name == "serving.rerank_batched"


@pytest.mark.parametrize("kw,match", [
    (dict(measure="remote-clique"), "GMM-prefix"),
    (dict(measure="nope"), "unknown measure"),
    (dict(k=0), "out of range"),
    (dict(k=70), "out of range"),
])
def test_rerank_batched_errors(kw, match):
    args = dict(k=4)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        rerank_batched(np.zeros((2, 64, 4), np.float32), device="cpu", **args)


def test_rerank_batched_ragged_errors():
    with pytest.raises(ValueError, match="dim"):
        rerank_batched([np.zeros((10, 4), np.float32),
                        np.zeros((10, 5), np.float32)], k=2, device="cpu")
    with pytest.raises(ValueError, match=">= k=5"):
        rerank_batched([np.zeros((10, 4), np.float32),
                        np.zeros((3, 4), np.float32)], k=5, device="cpu")


# -- the session reranker ------------------------------------------------------

def _pair(**kw):
    return (OnlineReranker(device="cpu", **kw), RefReranker(**kw))


def assert_result(got, want):
    np.testing.assert_array_equal(got.slate, np.asarray(want.slate))
    assert got.reused == want.reused and got.generation == want.generation
    g, w = got.cert, want.cert
    assert (g.kprime, g.kind, g.counts, g.meets_target) == \
        (w.kprime, w.kind, w.counts, w.meets_target)
    for f in ("radius", "scale", "ratio"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=RTOL)
    np.testing.assert_allclose(g.radii, w.radii, rtol=RTOL)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique",
                                     "remote-star"])
def test_rerank_and_rerank_many_match_reference(measure):
    port, ref = _pair(k=4, dim=8, kprime=16, measure=measure, eps=0.5)
    base = _chunks(200, 8, 1, seed=8)[0]
    stream = [base, base[:50] + 1e-4] + _chunks(64, 8, 3, seed=6, scale=3.0)
    for i, c in enumerate(stream):
        if i % 2:
            assert_result(port.rerank("u", c), ref.rerank("u", c))
        else:
            got = port.rerank_many({"u": c, "v": c[::-1] * 2})
            want = ref.rerank_many({"u": c, "v": c[::-1] * 2})
            for key in ("u", "v"):
                assert_result(got[key], want[key])
    assert port.stats() == ref.stats()
    # a delegate-keeping (ext) session changes with every absorbed batch
    assert (port.stats()["reuse_hits"] >= 1) == (measure == "remote-edge")


def test_pre_boot_session_matches_reference():
    port, ref = _pair(k=4, dim=8, kprime=16)
    c = _chunks(6, 8, 1, seed=3)[0]                 # fewer than k'+1 rows
    assert_result(port.rerank("u", c), ref.rerank("u", c))
    assert port.store.get("u").coreset.state is None


def test_rerank_single_equals_many():
    chunks = _chunks(64, 8, 3, seed=6)
    a = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
    b = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
    for c in chunks:
        ra, rb = a.rerank("u", c), b.rerank_many({"u": c})["u"]
        np.testing.assert_array_equal(ra.slate, rb.slate)
        assert ra.cert == rb.cert


def test_chunk_invariance_and_independent_sessions():
    chunks = _chunks(50, 8, 4, seed=7)
    whole = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
    split = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
    res_w = whole.rerank("u", np.concatenate(chunks))
    for c in chunks:
        res_s = split.rerank("u", c)
    np.testing.assert_array_equal(res_w.slate, res_s.slate)
    assert res_w.cert == res_s.cert
    many = split.rerank_many({"a": chunks[0], "b": chunks[1]})
    solo = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
    np.testing.assert_array_equal(solo.rerank("b", chunks[1]).slate,
                                  many["b"].slate)


def test_fused_solve_equals_the_single_session_solver():
    """The fused b=1 GMM over the session's centers picks what the
    sequential solver picks on the session's core-set."""
    from repro_torch.core.sequential import solve_on_coreset

    rr = OnlineReranker(k=5, dim=6, kprime=20, device="cpu")
    for c in _chunks(80, 6, 3, seed=11, scale=2.0):
        res = rr.rerank("u", c)
    cs = rr.store.get("u").coreset.finalize()
    want = solve_on_coreset(cs, 5, "remote-edge", metric="euclidean")
    np.testing.assert_array_equal(np.sort(res.slate, axis=0),
                                  np.sort(want.numpy(), axis=0))


def test_constrained_sessions_match_reference():
    from repro.constrained import PartitionMatroid as RefPM
    from repro_torch.constrained import PartitionMatroid

    rng = np.random.default_rng(5)
    port = OnlineReranker(k=4, dim=6, kprime=16, device="cpu",
                          matroid=PartitionMatroid([2, 2]))
    ref = RefReranker(k=4, dim=6, kprime=16, matroid=RefPM([2, 2]))
    for _ in range(3):
        c = rng.normal(size=(60, 6)).astype(np.float32)
        lab = rng.integers(0, 2, 60)
        got, want = port.rerank("u", c, lab), ref.rerank("u", c, lab)
        np.testing.assert_array_equal(got.slate, np.asarray(want.slate))
        np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    with pytest.raises(ValueError, match="labels"):
        port.rerank("u", c)
    with pytest.raises(ValueError, match="constrained"):
        port.save_session("u", None, 0)


@pytest.mark.parametrize("kw,match", [
    (dict(k=8, n=3), "k=8"), (dict(n=10, d=5), "dim")])
def test_reranker_errors(kw, match):
    rr = OnlineReranker(k=kw.get("k", 4), dim=4, device="cpu")
    with pytest.raises(ValueError, match=match):
        rr.rerank("u", np.zeros((kw["n"], kw.get("d", 4)), np.float32))


def test_lru_evictions_under_budget_match_reference():
    probe, _ = _pair(k=4, dim=8, kprime=16)
    probe.rerank("probe", _chunks(40, 8, 1, seed=12)[0])
    per = probe.stats()["nbytes"]
    port, ref = _pair(k=4, dim=8, kprime=16, memory_budget_bytes=3 * per)
    for i in range(8):
        c = _chunks(40, 8, 1, seed=20 + i)[0]
        port.rerank(f"u{i}", c)
        ref.rerank(f"u{i}", c)
        if i == 5:
            port.rerank("u3", c[:10])                 # touch u3
            ref.rerank("u3", c[:10])
    assert port.stats() == ref.stats()
    assert port.store.keys() == ref.store.keys()
    assert port.stats()["evictions"] == 5
    assert set(port.store.keys()) == {"u3", "u6", "u7"}


def test_session_nbytes_and_store_lifecycle():
    port, ref = _pair(k=4, dim=8, kprime=16, measure="remote-clique")
    c = _chunks(40, 8, 1, seed=17)[0]
    port.rerank("u", c)
    ref.rerank("u", c)
    sess = port.store.get("u")
    assert sess.nbytes == session_nbytes(sess.coreset) == \
        ref.store.get("u").nbytes
    port.end_session("u")
    assert port.stats()["sessions_active"] == 0 and port.store.nbytes == 0
    store = SessionStore(memory_budget_bytes=1)
    tiny = OnlineReranker(k=4, dim=8, kprime=16, device="cpu",
                          memory_budget_bytes=1)
    assert tiny.rerank("u", c).slate.shape == (4, 8)
    assert tiny.stats()["sessions_active"] == 1 and store.active == 0


@pytest.mark.parametrize("manager", ["port", "reference"])
def test_save_restore_session_through_either_manager(manager):
    chunks = _chunks(64, 8, 4, seed=18)
    make = CheckpointManager if manager == "port" else RefManager
    with tempfile.TemporaryDirectory() as d:
        mgr = make(d)
        rr = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
        rr.rerank("u", chunks[0])
        rr.rerank("u", chunks[1])
        rr.save_session("u", mgr, step=2)
        rr2 = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
        assert rr2.restore_session("u", mgr)
        for c in chunks[2:]:
            a, b = rr2.rerank("u", c), rr.rerank("u", c)
            np.testing.assert_array_equal(a.slate, b.slate)
            assert a.cert == b.cert
        # the reference restores the port's session too, and goes on alike
        ref = RefReranker(k=4, dim=8, kprime=16)
        assert ref.restore_session("u", RefManager(d))
        want = ref.rerank("u", chunks[2])
        got = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
        assert got.restore_session("u", mgr)
        assert_result(got.rerank("u", chunks[2]), want)


def test_restore_missing_and_save_unknown():
    with tempfile.TemporaryDirectory() as d:
        rr = OnlineReranker(k=4, dim=8, kprime=16, device="cpu")
        assert not rr.restore_session("u", CheckpointManager(d))
        with pytest.raises(KeyError):
            rr.save_session("ghost", CheckpointManager(d), step=0)


def test_serving_counters_match_reference():
    from repro.obs.trace import RunTrace as RefTrace
    from repro.obs.trace import activate as ref_activate

    base = _chunks(200, 8, 1, seed=19)[0]
    other = _chunks(60, 8, 1, seed=21)[0]
    traces = []
    for rr, tr, act in ((OnlineReranker(k=4, dim=8, kprime=16,
                                        device="cpu"),
                         RunTrace(enabled=True), activate),
                        (RefReranker(k=4, dim=8, kprime=16),
                         RefTrace(enabled=True), ref_activate)):
        with act(tr):
            rr.rerank("u", base)
            rr.rerank("u", base[:50] + 1e-4)
            rr.rerank_many({"u": base[:50] + 2e-4, "v": other})
        traces.append(tr)
    names = ("sessions_active", "coreset_reuses", "rerank_batched")
    got, want = ({n: t.counters.get(n, 0) for n in names} for t in traces)
    assert got == want == {"sessions_active": 2, "coreset_reuses": 2,
                           "rerank_batched": 2}


def test_engine_names_are_exported_and_other_families_wait():
    """The model-backed engine is ported (its parity tests are
    ``test_torch_serving_engine.py``); every family of the reference has a
    model in the port, and an engine over an unknown family raises
    ``ValueError`` naming it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine, diverse_rerank

    assert {"ServingEngine", "diverse_rerank", "Request"} <= set(
        repro_torch.serving.__all__)
    assert callable(diverse_rerank)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True),
                              family="no-such-family")
    with pytest.raises(ValueError, match="no-such-family"):
        ServingEngine(cfg, None, None)


# -- the facade --------------------------------------------------------------

def test_facade_auto_and_requested_serving_match_reference():
    batch = np.stack(_chunks(100, 16, 8, seed=3))
    want = repro.diversify(batch, k=5)
    for ex in (repro_torch.ExecutionSpec(device="cpu"),
               repro_torch.ExecutionSpec(device="cpu", mode="serving")):
        got = repro_torch.diversify(batch, k=5, execution=ex)
        assert got.plan.mode == "serving" and got.plan.requests == 8
        assert got.solution.shape == (8, 5, 16)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(
            got.solution, np.take_along_axis(batch, got.indices[:, :, None],
                                             axis=1))
        np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
        np.testing.assert_allclose(got.telemetry["values"],
                                   want.telemetry["values"], rtol=RTOL)
        np.testing.assert_allclose(got.telemetry["radii"],
                                   want.telemetry["radii"], rtol=1e-4)
        assert got.cert is None and got.coreset is None


def test_facade_explain_equals_reference():
    batch = np.zeros((8, 100, 16), np.float32)
    want = repro.plan(repro.ProblemSpec(points=batch, k=5))
    got = repro_torch.plan(repro_torch.ProblemSpec(points=batch, k=5),
                           repro_torch.ExecutionSpec(device="cpu"))
    assert got.explain() == want.explain()
    assert (got.coreset_rows, got.coreset_bytes, got.layout) == \
        (want.coreset_rows, want.coreset_bytes, want.layout)
    res = got.execute()
    assert "measured: rerank=" in res.plan.explain(actual=True)


@pytest.mark.parametrize("spec_kw,exec_kw,msg", [
    (dict(labels=np.zeros(50, int), quotas=[3, 2]), {}, "unconstrained"),
    (dict(measure="remote-clique"), {}, "GMM-prefix"),
    (dict(k=60), {}, "exceeds"),
    ({}, dict(kprime=32), "no serving path"),
    ({}, dict(b=4), "no serving path"),
    ({}, dict(schedule=((2, 4),)), "no serving path"),
    ({}, dict(smm_mode="ext"), "no serving path"),
    ({}, dict(resilience="policy"), "nothing to retry"),
])
def test_knobs_without_serving_path_fail_at_plan_time(spec_kw, exec_kw, msg):
    from repro_torch.distributed import ResiliencePolicy

    if exec_kw.get("resilience") == "policy":
        exec_kw = dict(resilience=ResiliencePolicy())
    spec = dict(points=np.zeros((4, 50, 8), np.float32), k=5)
    spec.update(spec_kw)
    with pytest.raises(ValueError, match=msg):
        repro_torch.plan(repro_torch.ProblemSpec(**spec),
                         repro_torch.ExecutionSpec(device="cpu", **exec_kw))


def test_mode_shape_mismatches():
    with pytest.raises(ValueError, match="3-D"):
        repro_torch.plan(repro_torch.ProblemSpec(
            points=np.zeros((50, 8), np.float32), k=5),
            repro_torch.ExecutionSpec(device="cpu", mode="serving"))
    with pytest.raises(ValueError, match="serving"):
        repro_torch.plan(repro_torch.ProblemSpec(
            points=np.zeros((4, 50, 8), np.float32), k=5),
            repro_torch.ExecutionSpec(device="cpu", mode="batch"))
