"""The fault matrix of the reference's ``tests/test_resilience.py``, run on
the port and held against the reference on the same seeded inputs.

* retry — one injected failure, replayed under ``on_failure="retry"``,
  gives the port's no-fault result exactly (``torch.equal``/array equal:
  the injection fires before a unit touches any state); its solution equals
  the reference's to rtol 1e-5 (fp32 sums in another order), its counters
  (``retries``, ``failures_injected``, ``reducers_recovered``,
  ``checkpoints_written``) and resilience report exactly;
* degrade — a lost unit gives the reference's surviving shards and
  coverage fields exactly;
* resume — a stream killed mid-way and rerun from its checkpoint equals the
  uninterrupted stream exactly;
* ``trace="reducers"`` and the per-reducer resilient round 1 return
  ``torch.equal`` tensors to the one-run grouped path.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.distributed import FailureInjector as RefInjector
from repro.distributed import ResiliencePolicy as RefPolicy
from repro_torch.distributed import (FailureInjector, InjectedFailure,
                                     ResiliencePolicy, StragglerPolicy,
                                     TrainingSupervisor, degraded_certificate,
                                     retry_call, run_resilient, run_unit)
from repro_torch.distributed.fault_tolerance import ResilienceReport

RTOL = 1e-5
COUNTERS = ("retries", "failures_injected", "reducers_recovered",
            "checkpoints_written")


def _pts(n=640, d=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _labelled(n=640, d=4, seed=0):
    return _pts(n, d, seed), np.arange(n) % 3


def _policies(**kw):
    """(reference policy, port policy) with equal knobs and injectors."""
    fail_at = kw.pop("fail_at", ())
    rate = kw.pop("rate", 0.0)
    rp = RefPolicy(injector=RefInjector(fail_at=fail_at, rate=rate)
                   if (fail_at or rate) else None, **kw)
    pp = ResiliencePolicy(injector=FailureInjector(fail_at=fail_at,
                                                   rate=rate)
                          if (fail_at or rate) else None, **kw)
    return rp, pp


def _run(pkg, pts, k=4, pol=None, problem=None, **kw):
    problem = problem or {}
    ex = dict(resilience=pol, **kw)
    if pkg is repro_torch:
        ex["device"] = "cpu"
    return pkg.diversify(pkg.ProblemSpec(points=pts, k=k, **problem),
                         pkg.ExecutionSpec(**ex))


def _counters(res):
    c = res.telemetry["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _report(res):
    rep = dict(res.telemetry["resilience"])
    rep.pop("policy")
    return rep


def _cert_fields(cert):
    return (cert.degraded, cert.surviving_shards, cert.total_shards,
            cert.points_covered, cert.points_total)


# -- injector / policy units ----------------------------------------------

def test_injector_fires_once_and_rate_is_seeded_like_the_reference():
    for pkg_inj in (FailureInjector, RefInjector):
        inj = pkg_inj(fail_at=("reducer:1",))
        with pytest.raises(Exception, match="injected"):
            inj.maybe_fail("reducer:1")
        inj.maybe_fail("reducer:1")
        assert inj.fired == ("reducer:1",)

    def fired(inj):
        out = []
        for j in range(64):
            try:
                inj.maybe_fail(f"chunk:{j}")
            except Exception:
                out.append(j)
        return out

    assert fired(FailureInjector(rate=0.3, seed=7)) == \
        fired(RefInjector(rate=0.3, seed=7))


def test_policy_validation_and_describe_match_reference():
    for bad in (dict(on_failure="panic"), dict(max_retries=-1),
                dict(checkpoint_every=0)):
        with pytest.raises(ValueError):
            ResiliencePolicy(**bad)
    assert ResiliencePolicy(backoff_s=0.5).backoff(2) == 2.0
    for kw in (dict(), dict(max_retries=3, on_failure="degrade",
                            deadline_factor=2.5, speculate=True,
                            checkpoint_dir="/x", checkpoint_every=7)):
        rp, pp = _policies(rate=0.1, **kw)
        assert pp.describe() == rp.describe()


def test_run_resilient_retry_degrade_and_exhaustion():
    pol = ResiliencePolicy(max_retries=2,
                           injector=FailureInjector(fail_at=("reducer:1",)))
    out, rep = run_resilient(3, lambda i: i * 10, pol)
    assert out == [0, 10, 20]
    assert (rep.retries, rep.failures_injected, rep.recovered) == (1, 1, 1)
    out, rep = run_resilient(4, lambda i: i, ResiliencePolicy(
        on_failure="degrade",
        injector=FailureInjector(fail_at=("reducer:2",))))
    assert out == [0, 1, None, 3] and rep.survivors == (0, 1, 3)
    assert rep.to_dict()["degraded"]
    with pytest.raises(InjectedFailure):
        run_resilient(3, lambda i: i, ResiliencePolicy(
            max_retries=0, injector=FailureInjector(fail_at=("reducer:0",))))


def test_run_unit_and_retry_call():
    state = []
    rep = ResilienceReport(scope="chunk")
    pol = ResiliencePolicy(injector=FailureInjector(fail_at=("chunk:0",)))
    assert run_unit(lambda: state.append(1), pol, point="chunk:0", unit=0,
                    report=rep)
    assert state == [1] and rep.retries == 1 and rep.recovered == 1
    out, rep = retry_call(lambda: 42, ResiliencePolicy(
        max_retries=1, injector=FailureInjector(fail_at=("round:r",))),
        point="round:r")
    assert out == 42 and rep.retries == 1


def test_straggler_policy_flags_a_slow_unit():
    pol = StragglerPolicy(deadline_factor=3.0, min_history=3)
    assert not pol.observe(100.0)             # warm-up step never counts
    assert not any(pol.observe(1.0) for _ in range(3))
    assert pol.observe(10.0) and pol.history == (1.0, 1.0, 1.0, 10.0)


def test_degraded_certificate_mints_the_reference_fields():
    cert = degraded_certificate(None, kprime=16, radius=1.5,
                                survivors=[0, 2], total=4, per_shard=10)
    assert cert.kind == "mapreduce" and cert.radius == 1.5
    assert _cert_fields(cert) == (True, (0, 2), 4, 20, 40)


# -- plan ------------------------------------------------------------------

def test_plan_checks_and_explain_match_reference():
    pts = _pts()
    with pytest.raises(ValueError, match="batch"):
        repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=4),
                         repro_torch.ExecutionSpec(
                             device="cpu", mode="batch",
                             resilience=ResiliencePolicy()))
    with pytest.raises(TypeError, match="ResiliencePolicy"):
        repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=4),
                         repro_torch.ExecutionSpec(
                             device="cpu", mode="mapreduce", num_reducers=4,
                             resilience={"max_retries": 2}))
    pts3, lab = _labelled()
    with pytest.raises(ValueError, match="constrained"):
        repro_torch.plan(
            repro_torch.ProblemSpec(points=pts3, k=6, labels=lab,
                                    quotas=[2, 2, 2]),
            repro_torch.ExecutionSpec(
                device="cpu", mode="streaming", kprime=16,
                resilience=ResiliencePolicy(checkpoint_dir="/x")))
    rp, pp = _policies(max_retries=3, on_failure="degrade", rate=0.1)
    for pkg, pol in ((repro, rp), (repro_torch, pp)):
        ex = dict(mode="mapreduce", num_reducers=4, kprime=16,
                  resilience=pol)
        if pkg is repro_torch:
            ex["device"] = "cpu"
        text = pkg.plan(pkg.ProblemSpec(points=pts, k=4),
                        pkg.ExecutionSpec(**ex)).explain()
        if pkg is repro:
            want = text
    assert text == want and "injector=armed" in text


# -- simulated MapReduce ----------------------------------------------------

MR = dict(mode="mapreduce", num_reducers=4, kprime=16, b=1)


@pytest.mark.parametrize("variant", ["plain", "ext", "gen"])
def test_mr_retry_equals_no_fault_and_counts_like_reference(variant):
    pts = _pts()
    problem = ({} if variant == "plain"
               else {"measure": "remote-clique"})
    kw = dict(MR, generalized=variant == "gen")
    base = _run(repro_torch, pts, problem=problem, **kw)
    rp, pp = _policies(max_retries=2, fail_at=("reducer:1",))
    got = _run(repro_torch, pts, pol=pp, problem=problem, trace=True, **kw)
    want = _run(repro, pts, pol=rp, problem=problem, trace=True, **kw)
    np.testing.assert_array_equal(got.solution, base.solution)
    assert got.value == base.value
    np.testing.assert_allclose(got.solution, np.asarray(want.solution),
                               rtol=RTOL, atol=RTOL)
    assert _counters(got) == _counters(want)
    assert _counters(got)["reducers_recovered"] == 1
    assert _report(got) == _report(want)


def test_mr_retry_with_auto_knobs_equals_no_fault():
    pts = _pts(2000, 5, seed=9)
    kw = dict(mode="mapreduce", num_reducers=4)
    problem = {"metric": "cosine"}
    base = _run(repro_torch, pts, k=6, problem=problem, **kw)
    got = _run(repro_torch, pts, k=6, problem=problem, pol=ResiliencePolicy(
        injector=FailureInjector(fail_at=("reducer:2",))), **kw)
    np.testing.assert_array_equal(got.solution, base.solution)
    assert torch.equal(got.coreset.points, base.coreset.points)
    assert got.cert == base.cert


@pytest.mark.parametrize("variant", ["plain", "ext", "gen"])
def test_mr_degrade_gives_reference_coverage(variant):
    pts = _pts()
    problem = ({} if variant == "plain"
               else {"measure": "remote-clique"})
    kw = dict(MR, generalized=variant == "gen")
    rp, pp = _policies(on_failure="degrade", fail_at=("reducer:1",))
    got = _run(repro_torch, pts, pol=pp, problem=problem, **kw)
    want = _run(repro, pts, pol=rp, problem=problem, **kw)
    assert _cert_fields(got.cert) == _cert_fields(want.cert)
    assert _cert_fields(got.cert) == (True, (0, 2, 3), 4, 480, 640)
    np.testing.assert_allclose(got.cert.radius, want.cert.radius, rtol=RTOL)
    assert got.telemetry["resilience"]["failed"] == [1]
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)


def test_mr_all_lost_and_raise():
    pts = _pts()
    with pytest.raises(RuntimeError, match="all"):
        _run(repro_torch, pts, pol=ResiliencePolicy(
            on_failure="degrade", injector=FailureInjector(
                fail_at=tuple(f"reducer:{i}" for i in range(4)))), **MR)
    with pytest.raises(InjectedFailure):
        _run(repro_torch, pts, pol=ResiliencePolicy(
            on_failure="raise",
            injector=FailureInjector(fail_at=("reducer:0",))), **MR)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique"])
def test_fair_mr_retry_and_degrade(measure):
    pts, lab = _labelled()
    problem = dict(labels=lab, quotas=[2, 2, 2], measure=measure)
    kw = dict(mode="mapreduce", num_reducers=4, kprime=24, b=1)
    base = _run(repro_torch, pts, k=6, problem=problem, **kw)
    rp, pp = _policies(max_retries=2, fail_at=("reducer:3",))
    got = _run(repro_torch, pts, k=6, pol=pp, problem=problem, trace=True,
               **kw)
    want = _run(repro, pts, k=6, pol=rp, problem=problem, trace=True, **kw)
    np.testing.assert_array_equal(got.solution, base.solution)
    np.testing.assert_array_equal(got.labels, base.labels)
    assert _counters(got) == _counters(want)
    rp, pp = _policies(on_failure="degrade", fail_at=("reducer:0",))
    got = _run(repro_torch, pts, k=6, pol=pp, problem=problem, **kw)
    want = _run(repro, pts, k=6, pol=rp, problem=problem, **kw)
    assert _cert_fields(got.cert) == _cert_fields(want.cert)
    assert _cert_fields(got.cert) == (True, (1, 2, 3), 4, 480, 640)
    np.testing.assert_array_equal(np.bincount(got.labels), [2, 2, 2])


# -- trace="reducers": per-reducer round 1 == the one-run round 1 ---------

@pytest.mark.parametrize("case", ["plain", "ext", "gen", "auto-cosine",
                                  "constrained", "constrained-ext"])
def test_reducer_spans_return_the_grouped_tensors(case):
    pts, lab = _labelled(1200, 5, seed=4)
    problem, kw = {}, dict(mode="mapreduce", num_reducers=4, kprime=16, b=1)
    if case in ("ext", "gen", "constrained-ext"):
        problem["measure"] = "remote-clique"
    if case == "gen":
        kw["generalized"] = True
    if case == "auto-cosine":
        problem["metric"] = "cosine"
        kw.update(kprime="auto", b="auto")
    if case.startswith("constrained"):
        problem.update(labels=lab, quotas=[2, 2, 2])
        kw["kprime"] = 24
    k = 6 if case.startswith("constrained") else 4
    base = _run(repro_torch, pts, k=k, problem=problem, trace=True, **kw)
    got = _run(repro_torch, pts, k=k, problem=problem, trace="reducers",
               **kw)
    np.testing.assert_array_equal(got.solution, base.solution)
    assert got.value == base.value and got.cert == base.cert
    if got.coreset is not None:
        assert torch.equal(got.coreset.points, base.coreset.points)
        aux = "valid" if hasattr(got.coreset, "valid") else "multiplicity"
        assert torch.equal(getattr(got.coreset, aux),
                           getattr(base.coreset, aux))
    names = [s.name for s in got.telemetry.spans[0].children
             if s.name == "mr.round1"]
    round1 = next(s for s in got.telemetry.spans[0].children
                  if s.name == "mr.round1")
    assert names == ["mr.round1"]
    assert [c.name for c in round1.children] == [f"mr.reducer[{i}]"
                                                 for i in range(4)]
    assert got.telemetry.extras["mr_stragglers"] == ()
    # the model counters equal the one-run path's but for one dispatch per
    # reducer, as the reference charges them
    gc, bc = got.telemetry.counters, base.telemetry.counters
    assert gc["device_dispatches"] == bc["device_dispatches"] + 3
    assert gc["distance_evals"] == bc["distance_evals"]


# -- streaming ---------------------------------------------------------------

def _chunks(n_chunks=10, seed=0):
    pts = _pts(seed=seed)
    return [pts[i * 64:(i + 1) * 64] for i in range(n_chunks)]


def _stream(pkg, chunks, pol=None, **kw):
    ex = dict(mode="streaming", kprime=16, resilience=pol, **kw)
    if pkg is repro_torch:
        ex["device"] = "cpu"
    return pkg.diversify(pkg.ProblemSpec(points=iter(chunks), k=4),
                         pkg.ExecutionSpec(**ex))


def test_stream_retry_equals_no_fault_and_counts_like_reference():
    chunks = _chunks()
    base = _stream(repro_torch, chunks)
    rp, pp = _policies(max_retries=2, fail_at=("chunk:3",))
    got = _stream(repro_torch, chunks, pp, trace=True)
    want = _stream(repro, chunks, rp, trace=True)
    np.testing.assert_array_equal(got.solution, base.solution)
    assert got.value == base.value
    np.testing.assert_allclose(got.solution, np.asarray(want.solution),
                               rtol=RTOL, atol=RTOL)
    assert _counters(got) == _counters(want)
    assert _report(got) == _report(want)
    assert got.telemetry["resilience"]["scope"] == "chunk"


def test_stream_degrade_drops_chunk_with_reference_accounting():
    chunks = _chunks()
    rp, pp = _policies(on_failure="degrade", fail_at=("chunk:4",))
    got = _stream(repro_torch, chunks, pp)
    want = _stream(repro, chunks, rp)
    assert _cert_fields(got.cert) == _cert_fields(want.cert)
    assert got.cert.points_covered == 640 - 64
    assert 4 not in got.cert.surviving_shards


def test_stream_kill_resume_equals_uninterrupted(tmp_path):
    chunks = _chunks()
    base = _stream(repro_torch, chunks)
    with pytest.raises(InjectedFailure):
        _stream(repro_torch, chunks, ResiliencePolicy(
            on_failure="raise", checkpoint_dir=str(tmp_path),
            checkpoint_every=3,
            injector=FailureInjector(fail_at=("chunk:7",))))
    res = _stream(repro_torch, chunks, ResiliencePolicy(
        checkpoint_dir=str(tmp_path), checkpoint_every=3), trace=True)
    np.testing.assert_array_equal(res.solution, base.solution)
    assert res.value == base.value and res.cert == base.cert
    assert torch.equal(res.coreset.points, base.coreset.points)
    rs = res.telemetry["resilience"]
    assert rs["resumed_from"] == 6
    assert res.telemetry.counters["checkpoints_written"] == 1


def test_stream_resume_from_a_reference_checkpoint(tmp_path):
    """The reference kills its stream; the port resumes it from the
    reference's checkpoint and ends where the port's own run ends."""
    chunks = _chunks()
    base = _stream(repro_torch, chunks)
    with pytest.raises(Exception, match="injected"):
        _stream(repro, chunks, RefPolicy(
            on_failure="raise", checkpoint_dir=str(tmp_path),
            checkpoint_every=2, injector=RefInjector(fail_at=("chunk:5",))))
    res = _stream(repro_torch, chunks, ResiliencePolicy(
        checkpoint_dir=str(tmp_path), checkpoint_every=2))
    assert res.telemetry["resilience"]["resumed_from"] == 4
    np.testing.assert_array_equal(res.solution, base.solution)
    assert res.cert == base.cert


def test_stream_checkpoints_written_match_reference(tmp_path):
    chunks = _chunks(9)
    rp, pp = (RefPolicy(checkpoint_dir=str(tmp_path / "r"),
                        checkpoint_every=2),
              ResiliencePolicy(checkpoint_dir=str(tmp_path / "p"),
                               checkpoint_every=2))
    got = _stream(repro_torch, chunks, pp, trace=True)
    want = _stream(repro, chunks, rp, trace=True)
    assert _counters(got) == _counters(want)
    assert _counters(got)["checkpoints_written"] == 4
    np.testing.assert_array_equal(got.solution,
                                  _stream(repro_torch, chunks).solution)


def test_fair_stream_chunk_retry_and_degrade():
    pts, lab = _labelled()
    spec = dict(labels=lab, quotas=[2, 2, 2])
    kw = dict(mode="streaming", kprime=24, chunk=80)
    base = _run(repro_torch, pts, k=6, problem=spec, **kw)
    rp, pp = _policies(max_retries=1, fail_at=("chunk:2",))
    got = _run(repro_torch, pts, k=6, pol=pp, problem=spec, trace=True, **kw)
    want = _run(repro, pts, k=6, pol=rp, problem=spec, trace=True, **kw)
    np.testing.assert_array_equal(got.solution, base.solution)
    np.testing.assert_array_equal(got.labels, base.labels)
    assert _counters(got) == _counters(want)
    assert _report(got) == _report(want)


# -- training supervisor -------------------------------------------------

def test_training_supervisor_resumes_to_the_uninterrupted_state(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    def step_fn(state, batch, step):
        w = state["w"]
        w.add_(0.1 * (batch - w))             # an in-place update
        return state, {"loss": float(torch.sum((batch - w) ** 2))}

    def batch_fn(step):
        return torch.full((3,), float(step))

    clean = TrainingSupervisor(CheckpointManager(str(tmp_path / "a")),
                               policy=ResiliencePolicy(checkpoint_every=4))
    want = clean.run({"w": torch.zeros(3)}, step_fn, 10, batch_fn)
    sup = TrainingSupervisor(
        CheckpointManager(str(tmp_path / "b")),
        policy=ResiliencePolicy(checkpoint_every=4, injector=FailureInjector(
            fail_at=(2, 6))))
    got = sup.run({"w": torch.zeros(3)}, step_fn, 10, batch_fn)
    assert torch.equal(got["w"], want["w"])
    assert sup.report.resumes == 2 and sup.report.final_step == 10
    # the replay after the last resume (steps 4..9) repeats the clean losses
    assert sup.report.losses[-6:] == clean.report.losses[-6:]
    # a fresh supervisor on the finished directory resumes at the end
    again = TrainingSupervisor(CheckpointManager(str(tmp_path / "b")))
    out = again.run({"w": torch.zeros(3)}, step_fn, 10, batch_fn)
    assert torch.equal(out["w"], want["w"]) and again.report.steps_run == 0
