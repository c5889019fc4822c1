"""End-to-end parity of the port's constrained facade:
``repro_torch.diversify`` with ``labels=`` and quotas, a ranged
``PartitionMatroid``, labels alone, a ``TransversalMatroid`` or a
``LaminarMatroid``, in batch and streaming mode, against ``repro.diversify``
on the same numpy inputs.

The port runs on the CPU (``device="cpu"``, its plain torch path).  The
solution's rows, ``indices`` and ``labels``, the ``explain()`` text and the
telemetry extras must be equal; the value to rtol 1e-4 (the reference's
end-to-end parity), the certificate's floats (worst-group and per-group
ratios) to rtol 1e-4; a group whose rows are all centers has radius 0 up
to the factorized euclidean form's rounding (about 1e-3 here), so its
ratio agrees to atol 2e-3; and where that rounding meets a certificate's
scale (a stream's group holding exactly k centers: the reference's scale
is 0 and its ratio inf), the port's ratio must be inf or above 1e3.  Counters: a batch run's engine counters
(``device_dispatches``, ``distance_evals``, ``bytes_swept``,
``host_syncs`` with host pacing, ``pool_widenings``, ``sprint_segments``)
equal the reference's; with sprint the port reads one flag per round, so
its ``host_syncs`` count more.  A stream's algorithmic counters
(``points_absorbed``, ``merges``, ``distance_evals``, ``bytes_swept``)
equal the reference's; its tile and read counts are the port's own work.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.constrained import matroid as rmat
from repro.constrained.coreset import grouped_coreset as r_grouped_coreset
from repro_torch.constrained import matroid as pmat
from repro_torch.interop import from_reference, to_numpy

RTOL = 1e-4
SELF_ATOL = 2e-3


def _data(n=900, d=4, m=3, seed=0):
    rg = np.random.default_rng(seed)
    pts = rg.normal(size=(n, d)).astype(np.float32)
    lab = rg.choice(m, size=n, p=np.array([0.5, 0.3, 0.2])[:m] /
                    np.array([0.5, 0.3, 0.2])[:m].sum()).astype(np.int32)
    return pts, lab


def _matroids(kind):
    """(port oracle, reference oracle, k) for one constraint kind."""
    if kind == "quotas":
        return None, None, 6
    if kind == "ranged":
        args = dict(q_min=[1, 1, 0], q_max=[3, 3, 2], k=6)
        return (pmat.PartitionMatroid(**args), rmat.PartitionMatroid(**args),
                6)
    if kind == "transversal":
        elig = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]], bool)
        return (pmat.TransversalMatroid(elig), rmat.TransversalMatroid(elig),
                4)
    if kind == "laminar":
        fam = [([0, 1], 3), ([2], 2), ([0, 1, 2], 5)]
        return pmat.LaminarMatroid(3, fam), rmat.LaminarMatroid(3, fam), 5
    return None, None, 6                          # labels alone


def _both(kind, pts, lab, mode, measure="remote-edge", metric="euclidean",
          streamed_pairs=False, **kw):
    pm, rm, k = _matroids(kind)
    quotas = [2, 2, 2] if kind == "quotas" else None

    def problem(pkg, mat):
        src = pts
        if streamed_pairs:
            src = ((pts[i:i + 200], lab[i:i + 200])
                   for i in range(0, len(pts), 200))
        return pkg.ProblemSpec(points=src, k=k, measure=measure,
                               metric=metric,
                               labels=None if streamed_pairs else lab,
                               matroid=mat, quotas=quotas)

    want = repro.diversify(problem(repro, rm), repro.ExecutionSpec(
        mode=mode, trace=True, **kw))
    got = repro_torch.diversify(problem(repro_torch, pm),
                                repro_torch.ExecutionSpec(
                                    mode=mode, trace=True, device="cpu",
                                    **kw))
    return want, got


def assert_result_equal(got, want):
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    np.testing.assert_array_equal(got.solution, np.asarray(want.solution))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    if want.indices is None:
        assert got.indices is None
    else:
        np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    assert got.plan.explain() == want.plan.explain()
    assert got.telemetry.extras == want.telemetry.extras
    assert [p["name"] for p in got.telemetry.phases] == \
        [p["name"] for p in want.telemetry.phases]
    gc, wc = got.cert, from_reference(want.cert)
    if wc is None:
        assert gc is None
        return
    assert (gc.kind, gc.kprime, gc.counts, gc.b_schedule,
            gc.meets_target) == (wc.kind, wc.kprime, wc.counts,
                                 wc.b_schedule, wc.meets_target)
    np.testing.assert_allclose((gc.radius, gc.scale, gc.ratio),
                               (wc.radius, wc.scale, wc.ratio), rtol=RTOL)
    g_r, w_r = np.asarray(gc.group_ratios), np.asarray(wc.group_ratios)
    fin = np.isfinite(w_r)
    np.testing.assert_allclose(g_r[fin], w_r[fin], rtol=RTOL, atol=SELF_ATOL)
    assert np.all(g_r[~fin] > 1e3)


BATCH_KEYS = ("device_dispatches", "distance_evals", "bytes_swept",
              "pool_widenings", "sprint_segments")


@pytest.mark.parametrize("kind", ["quotas", "ranged", "labels",
                                  "transversal", "laminar"])
@pytest.mark.parametrize("knobs", [dict(kprime=24, b=1),
                                   dict(kprime=24, b="auto", sprint=False),
                                   dict()])
def test_batch_matches_reference(kind, knobs):
    pts, lab = _data(n=600)
    want, got = _both(kind, pts, lab, "batch", **knobs)
    assert_result_equal(got, want)
    keys = BATCH_KEYS + (("host_syncs",) if knobs.get("sprint") is False
                         else ())
    for key in keys:
        assert got.telemetry.counters.get(key, 0) == \
            want.telemetry.counters.get(key, 0), key
    assert np.all(lab[got.indices] == got.labels)


@pytest.mark.parametrize("measure", ["remote-clique", "remote-tree"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_batch_ext_measures_match_reference(measure, metric):
    pts, lab = _data(seed=3)
    want, got = _both("quotas", pts, lab, "batch", measure=measure,
                      metric=metric, kprime=8, b=1)
    assert_result_equal(got, want)


@pytest.mark.parametrize("kind,measure", [
    ("quotas", "remote-edge"), ("ranged", "remote-edge"),
    ("labels", "remote-edge"), ("transversal", "remote-clique")])
def test_streaming_matches_reference(kind, measure):
    pts, lab = _data(n=800, seed=1)
    want, got = _both(kind, pts, lab, "streaming", measure=measure,
                      kprime=12, chunk=400)
    assert_result_equal(got, want)
    for key in ("points_absorbed", "merges", "distance_evals",
                "bytes_swept"):
        assert got.telemetry.counters.get(key, 0) == \
            want.telemetry.counters.get(key, 0), key


def test_stream_of_labelled_chunks_matches_reference():
    pts, lab = _data(n=800, seed=2)
    want, got = _both("quotas", pts, lab, "streaming", streamed_pairs=True,
                      kprime=12)
    assert_result_equal(got, want)
    assert got.indices is None


def test_constrained_stream_indices_carry_the_solution_labels():
    """Row recovery of a constrained stream matches each solution point
    only against rows of its own group: with duplicated points across
    groups, an unrestricted match would return rows of the wrong group."""
    pts, lab = _data(n=600, seed=4)
    pts = np.concatenate([pts, pts])              # every point twice ...
    lab = np.concatenate([lab, (lab + 1) % 3])    # ... in another group
    res = repro_torch.diversify(
        pts, k=6, labels=lab, quotas=[2, 2, 2],
        execution=repro_torch.ExecutionSpec(mode="streaming", kprime=16,
                                            chunk=200, device="cpu"))
    idx = res.indices
    assert len(set(idx.tolist())) == 6
    np.testing.assert_array_equal(lab[idx], res.labels)
    np.testing.assert_array_equal(pts[idx], res.solution)
    assert np.bincount(res.labels, minlength=3).tolist() == [2, 2, 2]


def test_grouped_coreset_round_trips_through_interop():
    pts, lab = _data(n=500, seed=5)
    want = r_grouped_coreset(pts, lab, 3, 4, 12, b=4)
    got = from_reference(want, device="cpu")
    assert type(got).__name__ == "GroupedCoreset"
    assert got.idx.dtype == torch.int64 and got.valid.dtype == torch.bool
    back = to_numpy(got)
    for f in ("idx", "valid", "radius", "group_count"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(want, f)))
    ci, cl = got.flatten()
    wi, wl = want.flatten()
    np.testing.assert_array_equal(ci, np.asarray(wi))
    np.testing.assert_array_equal(cl, wl)
    assert got.size == want.size


def test_later_slices_and_bad_specs_raise(tmp_path):
    pts, lab = _data(n=200)
    ex = repro_torch.ExecutionSpec
    spec = repro_torch.ProblemSpec(points=pts, k=6, labels=lab)
    # the simulated reducers are ported, with per-reducer spans and
    # resilience= (slice 12), and the mesh path (slice 10b): mesh= wins
    # over num_reducers, as in the reference
    from repro_torch.distributed import ResiliencePolicy
    from test_torch_mesh import one_rank_mesh

    with one_rank_mesh(tmp_path) as mesh:
        planned = repro_torch.plan(spec, ex(device="cpu", num_reducers=4,
                                            mesh=mesh))
        res = planned.execute()
    assert planned.mode == "mapreduce" and planned.num_reducers is None
    assert planned.layout.startswith("mesh torch.distributed over axes "
                                     "('data',), 1 reducers")
    np.testing.assert_array_equal(np.bincount(res.labels, minlength=3),
                                  np.bincount(lab[res.indices], minlength=3))
    np.testing.assert_array_equal(pts[res.indices], res.solution)
    assert repro_torch.plan(spec, ex(device="cpu", mode="mapreduce",
                                     num_reducers=4,
                                     trace="reducers")).mode == "mapreduce"
    assert repro_torch.plan(spec, ex(
        device="cpu", mode="streaming",
        resilience=ResiliencePolicy())).mode == "streaming"
    with pytest.raises(TypeError, match="ResiliencePolicy"):
        repro_torch.plan(spec, ex(device="cpu", mode="streaming",
                                  resilience=object()))
    with pytest.raises(ValueError, match="not both"):
        repro_torch.plan(repro_torch.ProblemSpec(
            points=pts, k=6, labels=lab, quotas=[2, 2, 2],
            matroid=pmat.PartitionMatroid([2, 2, 2])), ex(device="cpu"))
    with pytest.raises(ValueError, match="sum"):
        repro_torch.plan(repro_torch.ProblemSpec(
            points=pts, k=6, labels=lab, quotas=[2, 2, 1]), ex(device="cpu"))
    with pytest.raises(ValueError, match="needs matroid"):
        repro_torch.plan(repro_torch.ProblemSpec(
            points=iter([(pts, lab)]), k=6, labels=lab), ex(device="cpu"))
    with pytest.raises(ValueError, match="constrained path"):
        repro_torch.plan(spec, ex(device="cpu", generalized=True))
