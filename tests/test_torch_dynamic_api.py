"""``mode="dynamic"`` through the port's facade against the reference's:
update streams auto-select the mode (before the chunk-iterator rule), an
``(n, d)`` array is a one-insert stream, every rejection of the reference
raises the same error type, ``explain()`` prints the reference's text on
every line but ``layout`` (which says where the cover lives), and on
integer-lattice points (exact in both packages) the picks, value,
certificate and counters equal the reference's.  Resilience: a dropped op
stamps the certificate as the reference does, a killed run resumes equal
to the uninterrupted one, and a run the reference's facade checkpointed
resumes in the port's."""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
from repro.distributed import FailureInjector as RefInjector
from repro.distributed import ResiliencePolicy as RefPolicy
from repro.distributed.fault_tolerance import InjectedFailure as RefFailure
from repro_torch.distributed import (FailureInjector, InjectedFailure,
                                     ResiliencePolicy)

K = 6


def _lattice(rng, n, d):
    return rng.integers(-50, 51, size=(n, d)).astype(np.float32)


def _ops(pkg, seed=3, d=5, rounds=12, gen=_lattice, tagged=False):
    """A mixed insert/delete stream (every third op deletes 15 ids well
    below the insert frontier), as ``pkg``'s ops or as tagged pairs."""
    rng = np.random.default_rng(seed)
    raw = [("insert", gen(rng, 300, d))]
    for j in range(rounds):
        if j % 3 == 2:
            raw.append(("delete", np.arange(j * 15, j * 15 + 15)))
        else:
            raw.append(("insert", gen(rng, 40, d)))
    if tagged:
        return raw
    return [pkg.Insert(v) if t == "insert" else pkg.Delete(v)
            for t, v in raw]


def _gauss(rng, n, d):
    return (rng.normal(size=(n, d)) * 10.0).astype(np.float32)


def _ex(pkg, **kw):
    if pkg is repro_torch:
        kw.setdefault("device", "cpu")
    return pkg.ExecutionSpec(**kw)


def _plan(pkg, points, ex=None, **problem):
    return pkg.plan(pkg.ProblemSpec(points=points, k=problem.pop("k", K),
                                    **problem), _ex(pkg, **(ex or {})))


def _counters(res, drop=("jit_recompiles",)):
    c = dict(res.telemetry["counters"])
    for key in drop:
        c.pop(key, None)
    return c


def test_update_streams_auto_select_dynamic():
    p = _plan(repro_torch, _ops(repro_torch))
    assert p.mode == "dynamic" and "update-stream" in p.reason
    assert p.updates == 13 and p.d == 5 and p.n is None
    assert p.knobs["kprime"] == 64                      # max(2k, 64)
    # tagged pairs too, and before the chunk-iterator rule
    p = _plan(repro_torch, _ops(repro_torch, tagged=True), k=40)
    assert p.mode == "dynamic" and p.knobs["kprime"] == 80
    # a list of plain arrays is still a chunk stream
    assert _plan(repro_torch, [np.zeros((8, 3), np.float32)]).mode == \
        "streaming"


def test_array_sugar_runs_and_matches_the_reference():
    pts = _lattice(np.random.default_rng(1), 250, 4)
    got = repro_torch.diversify(pts, k=K, execution=_ex(
        repro_torch, mode="dynamic"))
    want = repro.diversify(pts, k=K, execution=_ex(repro, mode="dynamic"))
    assert got.plan.updates == 1 and got.telemetry["mode"] == "dynamic"
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.solution, want.solution)
    assert dataclasses.asdict(got.cert) == dataclasses.asdict(want.cert)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-6)


SPECS = {
    "auto": (dict(), {}),
    "sugar": (dict(array=True), dict(mode="dynamic")),
    "kprime_cosine": (dict(metric="cosine"), dict(kprime=24)),
    "clique_manhattan": (dict(metric="manhattan", measure="remote-clique"),
                         dict(mode="dynamic")),
    "policy": (dict(), dict(rebuild="policy")),
    "resilience": (dict(), dict(resilience="policy", eps=0.2)),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_explain_equals_the_reference_but_layout(name):
    problem, ex = SPECS[name]
    problem, ex = dict(problem), dict(ex)
    texts = {}
    for pkg in (repro, repro_torch):
        pts = (_lattice(np.random.default_rng(0), 100, 5)
               if problem.get("array") else _ops(pkg))
        kw = dict(ex)
        if kw.get("rebuild") == "policy":
            kw["rebuild"] = pkg.RebuildPolicy(levels=6, max_updates=50)
        if kw.get("resilience") == "policy":
            kw["resilience"] = (RefPolicy if pkg is repro
                                else ResiliencePolicy)(checkpoint_every=3)
        prob = {k: v for k, v in problem.items() if k != "array"}
        texts[pkg] = _plan(pkg, pts, kw, **prob).explain().splitlines()
    want, got = texts[repro], texts[repro_torch]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b.startswith("  layout:"):
            assert a.startswith("  layout: leveled cover on the device")
            assert b.split("levels, ")[-1] == a.split("levels, ")[-1]
        else:
            assert a == b


REJECTIONS = {
    "stream_on_batch": (dict(), dict(mode="batch")),
    "constrained": (dict(labels=True, quotas=[3, 3]), {}),
    "non_metric": (dict(metric="sqeuclidean"), {}),
    "b": (dict(), dict(b=8)),
    "schedule": (dict(), dict(schedule=((1, K),))),
    "generalized": (dict(), dict(generalized=True)),
    "smm_mode": (dict(), dict(smm_mode="plain")),
    "num_reducers": (dict(), dict(num_reducers=4)),
    "mesh": (dict(), dict(mesh="mesh", mode="dynamic")),
    "rebuild_on_batch": (dict(array=True), dict(mode="batch",
                                                rebuild="policy")),
    "rebuild_type": (dict(), dict(rebuild="nonsense")),
    "chunk_iterator": (dict(iterator=True), dict(mode="dynamic")),
    "three_d": (dict(cube=True), dict(mode="dynamic")),
    "weights": (dict(array=True, weights=True), dict(mode="dynamic")),
    "three_round": (dict(), dict(three_round=True)),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_raise_the_reference_error_type(name):
    problem, ex = REJECTIONS[name]
    errors = {}
    for pkg in (repro, repro_torch):
        rng = np.random.default_rng(0)
        if problem.get("array"):
            pts = _lattice(rng, 60, 3)
        elif problem.get("iterator"):
            pts = iter([_lattice(rng, 60, 3)])
        elif problem.get("cube"):
            pts = _lattice(rng, 60, 3).reshape(3, 20, 3)
        else:
            pts = _ops(pkg, d=3)
        prob = {}
        if problem.get("labels"):
            prob.update(labels=np.arange(60) % 2, quotas=problem["quotas"])
        if "metric" in problem:
            prob["metric"] = problem["metric"]
        if problem.get("weights"):
            prob["weights"] = np.ones(60, np.int64)
        kw = dict(ex)
        if kw.get("rebuild") == "policy":
            kw["rebuild"] = pkg.RebuildPolicy()
        if kw.get("mesh") == "mesh":
            kw["mesh"] = object()
        with pytest.raises(Exception) as info:
            _plan(pkg, pts, kw, **prob)
        errors[pkg] = info.type
    assert errors[repro_torch] is errors[repro], errors
    assert errors[repro] in (ValueError, TypeError)


def test_lattice_churn_equals_the_reference_with_counters():
    got = repro_torch.diversify(
        repro_torch.ProblemSpec(points=_ops(repro_torch), k=K),
        _ex(repro_torch, kprime=24, trace=True))
    want = repro.diversify(repro.ProblemSpec(points=_ops(repro), k=K),
                           _ex(repro, kprime=24, trace=True))
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.solution, want.solution)
    assert dataclasses.asdict(got.cert) == dataclasses.asdict(want.cert)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-6)
    assert _counters(got) == _counters(want)
    assert _counters(got)["level_rebuilds"] >= 1
    for f in ("mode", "n_live", "updates", "rebuilds", "query_level",
              "coreset_size"):
        assert got.telemetry[f] == want.telemetry[f], f
    assert [p["name"] for p in got.telemetry["phases"]] == \
        ["updates", "query", "value"]
    text = got.plan.explain(actual=True)
    assert "measured:" in text and "level_rebuilds=" in text


def test_float_churn_runs_certified():
    rng = np.random.default_rng(8)
    ops = [repro_torch.Insert(_gauss(rng, 400, 6))] + [
        repro_torch.Delete(np.arange(j * 20, j * 20 + 20)) if j % 2 else
        ("insert", _gauss(rng, 50, 6)) for j in range(6)]
    res = repro_torch.diversify(ops, k=K, execution=_ex(
        repro_torch, eps=10.0))
    assert res.cert.kind == "dynamic" and res.cert.meets_target
    assert res.cert.deletions_absorbed == 60
    assert res.solution.shape == (K, 6) and len(set(res.indices)) == K


def test_degrade_drops_an_op_and_stamps_the_certificate():
    got = repro_torch.diversify(
        _ops(repro_torch), k=K, execution=_ex(
            repro_torch, kprime=24, resilience=ResiliencePolicy(
                on_failure="degrade",
                injector=FailureInjector(fail_at=("update:3",)))))
    want = repro.diversify(
        _ops(repro), k=K, execution=_ex(
            repro, kprime=24, resilience=RefPolicy(
                on_failure="degrade",
                injector=RefInjector(fail_at=("update:3",)))))
    assert got.cert.degraded and 3 not in got.cert.surviving_shards
    assert got.cert.total_shards == 13
    assert got.telemetry["resilience"]["failed"] == [3]
    assert dataclasses.asdict(got.cert) == dataclasses.asdict(want.cert)
    np.testing.assert_array_equal(got.indices, want.indices)
    rs, ws = got.telemetry["resilience"], want.telemetry["resilience"]
    assert {k: v for k, v in rs.items() if k != "policy"} == \
        {k: v for k, v in ws.items() if k != "policy"}


def test_kill_resume_equals_the_uninterrupted_run(tmp_path):
    prob = repro_torch.ProblemSpec(points=_ops(repro_torch, gen=_gauss), k=K)

    def ex(pol=None):
        return _ex(repro_torch, kprime=24, resilience=pol, trace=True)
    base = repro_torch.diversify(prob, ex())
    kill = ResiliencePolicy(on_failure="raise", checkpoint_dir=str(tmp_path),
                            checkpoint_every=4, injector=FailureInjector(
                                fail_at=("update:10",)))
    with pytest.raises(InjectedFailure):
        repro_torch.diversify(prob, ex(kill))
    res = repro_torch.diversify(prob, ex(ResiliencePolicy(
        checkpoint_dir=str(tmp_path), checkpoint_every=4)))
    np.testing.assert_array_equal(res.solution, base.solution)
    np.testing.assert_array_equal(res.indices, base.indices)
    assert res.cert == base.cert and res.value == base.value
    assert res.telemetry["resilience"]["resumed_from"] == 8
    assert res.telemetry["counters"]["checkpoints_written"] >= 1


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's facade killed mid-stream leaves its checkpoint; the
    port's facade resumes from it and answers what the reference's
    uninterrupted run answers (lattice points: exact in both)."""
    want = repro.diversify(_ops(repro), k=K, execution=_ex(repro, kprime=24))
    with pytest.raises(RefFailure):
        repro.diversify(_ops(repro), k=K, execution=_ex(
            repro, kprime=24, resilience=RefPolicy(
                on_failure="raise", checkpoint_dir=str(tmp_path),
                checkpoint_every=3,
                injector=RefInjector(fail_at=("update:7",)))))
    got = repro_torch.diversify(_ops(repro_torch), k=K, execution=_ex(
        repro_torch, kprime=24, resilience=ResiliencePolicy(
            checkpoint_dir=str(tmp_path), checkpoint_every=3)))
    assert got.telemetry["resilience"]["resumed_from"] == 6
    np.testing.assert_array_equal(got.indices, want.indices)
    assert dataclasses.asdict(got.cert) == dataclasses.asdict(want.cert)


def test_dynamic_needs_a_nonempty_stream():
    with pytest.raises(ValueError, match="empty"):
        repro_torch.diversify([repro_torch.Delete([])], k=2,
                              execution=_ex(repro_torch))
