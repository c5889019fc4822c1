"""End-to-end parity of the port's simulated MapReduce facade:
``repro_torch.diversify(..., ExecutionSpec(mode="mapreduce",
num_reducers=ℓ))`` against ``repro.diversify`` on the same numpy inputs, at
n = 2,000, d = 8 and ℓ in {2, 4, 8}, over the three partitions, numeric
and auto knobs, remote-edge, remote-clique (EXT) and the generalized
scheme.

The port runs on the CPU (``device="cpu"``, its plain torch path).  The
solution rows, ``indices``, the ``explain()`` text, the certificate's
counts, schedule and ``meets_target``, and the counters must be equal;
the value and the certificate's floats agree to rtol 1e-4, the reference's
end-to-end parity.  One counter is the port's own: where ``b`` or ``kprime``
is "auto", the probe runs the adaptive controller with sprint "auto" in
both packages (the reference does not pass the ``sprint`` knob to its
probe), and in sprint the port reads one flag per round where the
reference reads one per segment, so ``host_syncs`` is compared only on
pinned knobs (``tests/test_torch_mapreduce.py`` holds the host-paced probe's
counters equal).
"""
import numpy as np
import pytest

import repro
import repro_torch
from repro_torch.interop import from_reference, to_numpy

RTOL = 1e-4


def _pts(n=2000, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _both(pts, k, measure="remote-edge", metric="euclidean", **kw):
    kw.setdefault("mode", "mapreduce")
    want = repro.diversify(pts, k=k, measure=measure, metric=metric,
                           execution=repro.ExecutionSpec(trace=True, **kw))
    got = repro_torch.diversify(pts, k=k, measure=measure, metric=metric,
                                execution=repro_torch.ExecutionSpec(
                                    device="cpu", trace=True, **kw))
    return want, got


def _counters(res, drop=()):
    c = dict(res.telemetry.counters)
    for key in ("jit_recompiles",) + tuple(drop):
        c.pop(key, None)
    return c


def assert_same_run(got, want, exact_syncs=True):
    np.testing.assert_array_equal(got.solution, want.solution)
    if want.indices is None:
        assert got.indices is None
    else:
        np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert got.plan.explain() == want.plan.explain()
    drop = () if exact_syncs else ("host_syncs",)
    assert _counters(got, drop) == _counters(want, drop)
    assert got.telemetry.extras == want.telemetry.extras
    assert [p["name"] for p in got.telemetry["phases"]] == ["rounds"]
    gc, wc = got.cert, want.cert
    assert (gc is None) == (wc is None)
    if wc is not None:
        assert gc.kprime == wc.kprime and gc.counts == wc.counts
        assert gc.b_schedule == wc.b_schedule
        assert gc.meets_target == wc.meets_target
        np.testing.assert_allclose((gc.radius, gc.scale, gc.ratio),
                                   (wc.radius, wc.scale, wc.ratio),
                                   rtol=RTOL)
        np.testing.assert_allclose(gc.radii, wc.radii, rtol=RTOL)
    if got.coreset is not None:
        np.testing.assert_allclose(float(got.coreset.radius),
                                   float(want.coreset.radius), rtol=RTOL)


@pytest.mark.parametrize("ell,partition", [(2, "contiguous"), (4, "random"),
                                           (8, "adversarial")])
def test_remote_edge_pinned_knobs(ell, partition):
    want, got = _both(_pts(), 6, num_reducers=ell, partition=partition,
                      seed=5, kprime=32, b=1)
    assert_same_run(got, want)
    assert got.plan.num_reducers == ell and got.plan.mode == "mapreduce"
    assert got.telemetry.extras["coreset_size"] == ell * 32


@pytest.mark.parametrize("knobs", [dict(kprime=48, b=4),
                                   dict(kprime=40, b=8, chunk=512)])
def test_remote_edge_lookahead_blocks(knobs):
    want, got = _both(_pts(seed=1), 6, num_reducers=4, **knobs)
    assert_same_run(got, want)


@pytest.mark.parametrize("ell,partition", [(4, "contiguous"),
                                           (8, "random")])
def test_auto_knobs_probe_and_frozen_schedule(ell, partition):
    """Default knobs (kprime="auto", b="auto", sprint="auto"): the probe
    on a strided subsample freezes one schedule for every reducer."""
    want, got = _both(_pts(seed=2), 6, num_reducers=ell,
                      partition=partition)
    assert_same_run(got, want, exact_syncs=False)
    assert got.cert is not None and got.cert.b_schedule


def test_auto_knobs_with_eps_and_bars():
    want, got = _both(_pts(seed=3), 6, num_reducers=4, eps=0.3,
                      tau=0.2, cliff=0.4)
    assert_same_run(got, want, exact_syncs=False)
    assert got.telemetry.counters["host_syncs"] > 0


@pytest.mark.parametrize("knobs", [dict(kprime="auto", b=1),
                                   dict(kprime=32, b="auto")])
def test_one_auto_knob(knobs):
    want, got = _both(_pts(seed=4), 5, num_reducers=2, **knobs)
    assert_same_run(got, want, exact_syncs=False)


@pytest.mark.parametrize("b,partition", [(1, "contiguous"), (4, "random"),
                                         ("auto", "adversarial")])
def test_remote_clique_ext(b, partition):
    want, got = _both(_pts(seed=6), 6, "remote-clique", num_reducers=4,
                      kprime=16, b=b, partition=partition)
    assert_same_run(got, want, exact_syncs=b != "auto")
    assert got.plan.variant == "ext"


@pytest.mark.parametrize("measure", ["remote-star", "remote-tree",
                                     "remote-cycle"])
def test_other_measures(measure):
    want, got = _both(_pts(800, 4, seed=7), 4, measure, num_reducers=2,
                      kprime=16, b=1)
    assert_same_run(got, want)


@pytest.mark.parametrize("ell,b", [(4, 1), (8, "auto")])
def test_generalized_three_round_scheme(ell, b):
    want, got = _both(_pts(seed=8), 6, "remote-clique", num_reducers=ell,
                      kprime=16, b=b, generalized=True, partition="random")
    assert_same_run(got, want, exact_syncs=b != "auto")
    assert got.plan.variant == "gen" and got.indices is None
    np.testing.assert_array_equal(got.coreset.multiplicity.numpy(),
                                  np.asarray(want.coreset.multiplicity))
    np.testing.assert_array_equal(got.coreset.points.numpy(),
                                  np.asarray(want.coreset.points))


def test_cosine_metric_and_auto_mode_with_reducers():
    pts = _pts(seed=9)
    want, got = _both(pts, 6, metric="cosine", mode="auto", num_reducers=4,
                      kprime=24, b=2)
    assert_same_run(got, want)
    assert got.plan.reason == "auto: num_reducers=4"


def test_padding_rows_map_back_to_input_rows():
    """n not a multiple of ℓ: the padded rows repeat leading rows, and the
    recovered indices are rows of the caller's input."""
    pts = _pts(1999, 4, seed=10)
    want, got = _both(pts, 8, num_reducers=8, kprime=32, b=1)
    assert_same_run(got, want)
    assert got.indices.max() < 1999 and len(set(got.indices)) == 8
    np.testing.assert_array_equal(pts[got.indices], got.solution)


def test_explain_text_for_auto_and_constrained_plans():
    pts = _pts(500, 4)
    lab = np.random.default_rng(0).integers(0, 3, 500)
    for kw in (dict(num_reducers=4), dict(num_reducers=2, kprime=16, b=1,
                                          partition="random")):
        for labels in (None, lab):
            want = repro.plan(repro.ProblemSpec(points=pts, k=6,
                                                labels=labels),
                              repro.ExecutionSpec(mode="mapreduce", **kw))
            got = repro_torch.plan(
                repro_torch.ProblemSpec(points=pts, k=6, labels=labels),
                repro_torch.ExecutionSpec(mode="mapreduce", device="cpu",
                                          **kw))
            assert got.explain() == want.explain()
            assert got.coreset_rows == want.coreset_rows
            assert got.coreset_bytes == want.coreset_bytes


@pytest.mark.parametrize("kw,match", [
    (dict(mode="mapreduce", num_reducers=4), "mesh"),
    (dict(num_reducers=4), "mesh"),
    (dict(mode="mapreduce", num_reducers=4, resilience="policy"), None),
    (dict(mode="mapreduce", num_reducers=4, trace="reducers"), None),
    (dict(num_reducers=4, trace="reducers"), None)])
def test_not_ported_cases_raise_from_plan(kw, match, tmp_path):
    """The mesh path (slice 10b) plans and runs: ``mesh=`` (a one-rank gloo
    mesh here) wins over ``num_reducers``, as in the reference, and the
    run answers as the reference's mesh path on one device does;
    resilience= and trace="reducers" (slice 12) plan and run the
    per-reducer round 1, whose result equals the one-run path's."""
    from repro_torch.distributed import ResiliencePolicy
    from test_torch_mesh import one_rank_mesh

    pts = _pts(100, 3)
    spec = repro_torch.ProblemSpec(points=pts, k=3)
    if match == "mesh":
        import jax
        with one_rank_mesh(tmp_path) as mesh:
            got = repro_torch.diversify(spec, repro_torch.ExecutionSpec(
                device="cpu", kprime=8, mesh=mesh, **kw))
        want = repro.diversify(pts, k=3, execution=repro.ExecutionSpec(
            kprime=8, mesh=jax.make_mesh((1,), ("data",)), **kw))
        assert got.plan.mode == "mapreduce" and got.plan.mesh is not None
        assert got.plan.num_reducers is None
        np.testing.assert_array_equal(got.solution, want.solution)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
        return
    if kw.get("resilience") == "policy":
        kw["resilience"] = ResiliencePolicy()
    got = repro_torch.diversify(spec, repro_torch.ExecutionSpec(
        device="cpu", kprime=8, **kw))
    want = repro_torch.diversify(spec, repro_torch.ExecutionSpec(
        device="cpu", kprime=8, num_reducers=4))
    assert got.plan.mode == "mapreduce"
    np.testing.assert_array_equal(got.solution, want.solution)
    assert got.value == want.value and got.cert == want.cert


def test_mesh_functions_name_their_slice(tmp_path):
    """The mesh functions of slice 10b run: on a one-rank gloo mesh each
    gives the reference's answer on a one-device mesh."""
    import warnings

    import jax
    import jax.numpy as jnp
    from repro.constrained import mapreduce as rcmr
    from repro.core import distributed as rdist
    from repro_torch.constrained import mapreduce as pcmr
    from repro_torch.core import distributed as pdist
    from test_torch_mesh import one_rank_mesh

    pts = _pts(400, 3, seed=4)
    lab = np.arange(400, dtype=np.int32) % 2
    rmesh = jax.make_mesh((1,), ("data",))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with one_rank_mesh(tmp_path) as mesh:
            got = {
                "coreset": pdist.mr_coreset(pts, 4, 16, "remote-edge", mesh,
                                            device="cpu").points.numpy(),
                "diversity": pdist.mr_diversity(pts, 4, "remote-clique",
                                                mesh, kprime=16, b=1,
                                                device="cpu")[0],
                "grouped": pcmr.mr_grouped_coreset(
                    pts, lab, 2, 4, 16, "remote-edge", mesh,
                    device="cpu").points.numpy(),
                "fair": pcmr.mr_fair_diversity(pts, lab, [2, 2], mesh=mesh,
                                               kprime=16, b=1,
                                               device="cpu")[0]}
        (tmp_path / "pod").mkdir()
        with one_rank_mesh(tmp_path / "pod", (1, 1),
                           ("pod", "data")) as pod:
            got["recursive"] = pdist.mr_coreset_recursive(
                pts, 4, 16, "remote-edge", pod, device="cpu").points.numpy()
        want = {
            "coreset": np.asarray(rdist.mr_coreset(
                jnp.asarray(pts), 4, 16, "remote-edge", rmesh).points),
            "diversity": rdist.mr_diversity(pts, 4, "remote-clique", rmesh,
                                            kprime=16, b=1)[0],
            "grouped": np.asarray(rcmr.mr_grouped_coreset(
                jnp.asarray(pts), jnp.asarray(lab), 2, 4, 16, "remote-edge",
                rmesh).points),
            "fair": rcmr.mr_fair_diversity(pts, lab, [2, 2], mesh=rmesh,
                                           kprime=16, b=1)[0],
            "recursive": np.asarray(rdist.mr_coreset_recursive(
                jnp.asarray(pts), 4, 16, "remote-edge",
                jax.make_mesh((1, 1), ("pod", "data"))).points)}
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)


def test_plan_errors_match_reference():
    pts = _pts(100, 3)
    for kw in (dict(mode="mapreduce"), dict(mode="mapreduce", num_reducers=1),
               dict(mode="mapreduce", num_reducers=2, three_round=True),
               dict(mode="mapreduce", num_reducers=2, recursive=True)):
        with pytest.raises(ValueError) as r:
            repro.plan(repro.ProblemSpec(points=pts, k=3),
                       repro.ExecutionSpec(**kw))
        with pytest.raises(ValueError) as g:
            repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=3),
                             repro_torch.ExecutionSpec(device="cpu", **kw))
        assert str(g.value) == str(r.value)


def test_legacy_simulate_mr_warns_and_answers():
    from repro.core.distributed import simulate_mr as r_sim
    from repro_torch.core.distributed import simulate_mr as p_sim
    pts = _pts(600, 4, seed=11)
    with pytest.warns(DeprecationWarning):
        sol, val = p_sim(pts, 4, "remote-edge", num_reducers=3, kprime=16,
                         device="cpu")
    with pytest.warns(DeprecationWarning):
        rsol, rval = r_sim(pts, 4, "remote-edge", num_reducers=3, kprime=16)
    np.testing.assert_array_equal(sol, rsol)
    np.testing.assert_allclose(val, rval, rtol=RTOL)


def test_interop_round_trip_of_round1():
    """The reference's round-1 core-set solved by the port's solver, and the
    port's by the reference's, give the same solution."""
    from repro.core.sequential import solve_on_coreset as r_solve
    from repro_torch.core.sequential import solve_on_coreset as p_solve
    for gen in (False, True):
        want, got = _both(_pts(seed=12), 6, "remote-clique", num_reducers=4,
                          kprime=16, b=1, generalized=gen)
        ported = from_reference(want.coreset, device="cpu")
        back = to_numpy(got.coreset)
        sol_p = p_solve(ported, 6, "remote-clique").numpy()
        rtype = type(want.coreset)
        sol_r = r_solve(rtype(**back), 6, "remote-clique")
        np.testing.assert_array_equal(sol_p, np.asarray(sol_r))
        if not gen:
            np.testing.assert_array_equal(sol_p, got.solution)
        assert isinstance(ported, type(got.coreset))
        # the rows the solver reads (EXT: invalid delegate slots hold
        # arbitrary rows in both packages)
        keep = (ported.multiplicity > 0 if gen else ported.valid).numpy()
        np.testing.assert_array_equal(ported.points.numpy()[keep],
                                      got.coreset.points.numpy()[keep])


def _round1_span(res):
    todo = list(res.telemetry.spans)
    while todo:
        sp = todo.pop(0)
        if sp.name == "mr.round1":
            return sp
        todo.extend(sp.children)
    raise AssertionError("no mr.round1 span")


@pytest.mark.parametrize("knobs,labelled", [
    (dict(kprime=32, b=1), False), (dict(kprime=32, b=4), False),
    (dict(), False), (dict(kprime=32, b=4), True)])
def test_round1_span_records_schedule_folds_and_launches(knobs, labelled):
    """The ``mr.round1`` span records the schedule round 1 ran, its fold
    count and the kernel launches inside it (none on the CPU); without a
    probe, the schedule is the one the reference's model counters
    charge."""
    from repro_torch.core.gmm import schedule_fold_sizes
    n, ell, k = 2000, 4, 6
    pts = _pts(n, seed=13)
    labels = (np.random.default_rng(13).integers(0, 3, n).astype(np.int32)
              if labelled else None)
    ex = dict(mode="mapreduce", num_reducers=ell, trace=True, **knobs)
    want = repro.diversify(pts, k=k, labels=labels,
                           execution=repro.ExecutionSpec(**ex))
    got = repro_torch.diversify(pts, k=k, labels=labels,
                                execution=repro_torch.ExecutionSpec(
                                    device="cpu", **ex))
    sp = _round1_span(got)
    schedule = tuple(map(tuple, sp.attrs["schedule"]))
    folds = schedule_fold_sizes(schedule)
    assert sp.attrs["folds"] == len(folds)
    assert sp.attrs["reducers"] == ell
    assert sp.attrs["launches"] == dict.fromkeys(sp.attrs["launches"], 0)
    assert sum(b * r for b, r in schedule) == sp.attrs["kprime"]
    if got.cert is None:
        # no probe: the distance evaluations are round 1's alone
        per = -(-n // ell)
        assert (_counters(want)["distance_evals"]
                == ell * per * sum(folds))
