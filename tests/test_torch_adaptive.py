"""Port parity for ``core.adaptive``: the adaptive-b controller, auto-k'
growth and their certificates against the reference (lax path, which
tests/test_kernels shows equals its Pallas path), plus the sprint
bit-identity contract re-proven inside the port.

Picks and executed schedules must be equal; counts, kprime and
meets_target are equal.  Certificate radii, scales and ratios agree to
rtol 1e-5 (fp32 dot products are summed in another order by XLA and by
torch).  On the clustered fixtures the late radii are ~0.2 while the points'
squared norms are ~300: the factorized ||x||^2 + ||c||^2 - 2x.c cancels
and magnifies the 1e-7 summation-order difference by |x|^2 / r^2 ~ 1e4,
so there the radii are held to rtol 2e-3.
"""
import numpy as np
import pytest
import torch

from repro.core import adaptive as radaptive
from repro_torch import obs
from repro_torch.core import adaptive

RTOL = 1e-5


def _normal(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _clustered(n, d, clusters, seed):
    rg = np.random.default_rng(seed)
    cen = rg.normal(size=(clusters, d)) * 10.0
    lab = rg.integers(0, clusters, size=n)
    return (cen[lab] + 0.05 * rg.normal(size=(n, d))).astype(np.float32)


CLUSTERED_RTOL = 2e-3


def assert_cert_close(got, want, rtol=RTOL):
    assert got.kprime == want.kprime
    assert got.counts == want.counts
    assert got.b_schedule == want.b_schedule
    assert got.meets_target == want.meets_target
    assert got.eps_target == want.eps_target and got.kind == want.kind
    for f in ("radius", "scale", "ratio"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(got.radii, want.radii, rtol=rtol)


@pytest.mark.parametrize("data,k", [("normal", 40), ("clustered", 48)])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_gmm_adaptive_matches_reference(data, k, metric):
    pts = (_normal(3000, 3, 1) if data == "normal"
           else _clustered(3000, 3, 12, 2))
    rtol = RTOL if data == "normal" else CLUSTERED_RTOL
    want = radaptive.gmm_adaptive(pts, k, metric=metric)
    got = adaptive.gmm_adaptive(torch.as_tensor(pts), k, metric=metric)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.schedule == want.schedule and got.counts == want.counts
    np.testing.assert_allclose(got.traj, want.traj, rtol=rtol)
    assert_cert_close(got.cert, want.cert, rtol)


@pytest.mark.parametrize("shape,k,eps", [((5000, 32), 16, 0.1),
                                         ((4000, 2), 6, 0.5),
                                         ((3000, 4), 4, 0.3)])
def test_auto_kprime_matches_reference(shape, k, eps):
    pts = _normal(*shape, seed=shape[0])
    want = radaptive.auto_kprime(pts, k, eps)
    got = adaptive.auto_kprime(torch.as_tensor(pts), k, eps)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.schedule == want.schedule
    assert_cert_close(got.cert, want.cert)


def test_auto_kprime_clustered_resume_matches_reference():
    # clustered data truncates blocks, widens the pool and drops to the
    # exact b=1 resume: every controller branch runs
    pts = _clustered(4000, 2, 20, 3)
    want = radaptive.auto_kprime(pts, 5, 0.2)
    got = adaptive.auto_kprime(torch.as_tensor(pts), 5, 0.2)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert any(b == 1 for b, _ in got.schedule)
    assert_cert_close(got.cert, want.cert, CLUSTERED_RTOL)


@pytest.mark.parametrize("data", ["normal", "clustered"])
def test_sprint_is_bit_identical_inside_the_port(data):
    pts = torch.as_tensor(_normal(6000, 8, 4) if data == "normal"
                          else _clustered(6000, 8, 30, 5))
    runs, syncs = {}, {}
    for sprint in (False, True):
        tr = obs.RunTrace(enabled=True)
        with obs.activate(tr):
            runs[sprint] = adaptive.auto_kprime(pts, 8, 0.05, sprint=sprint)
        syncs[sprint] = dict(tr.counters)
    host, fast = runs[False], runs[True]
    assert torch.equal(host.idx, fast.idx)
    assert host.counts == fast.counts and host.schedule == fast.schedule
    np.testing.assert_array_equal(host.traj, fast.traj)
    assert host.cert == fast.cert
    assert torch.equal(host.min_dist, fast.min_dist)
    assert syncs[False].get("sprint_segments", 0) == 0
    if data == "normal":
        assert syncs[True]["sprint_segments"] >= 1
    # the same sweeps run either way: equal work counters
    for key in ("distance_evals", "bytes_swept"):
        assert syncs[True][key] == syncs[False][key]


def test_helpers_match_reference():
    for k, n in ((4, 3000), (16, 100000), (40, 300), (3, 10)):
        assert adaptive.auto_milestones(k, n) == radaptive.auto_milestones(
            k, n)
    for hist, eps, cur in (([(32, 0.8), (64, 0.4)], 0.3, 64),
                           ([(32, 0.4)], 0.1, 32),
                           ([(32, 0.4), (64, 0.4)], 0.1, 64)):
        assert adaptive._secant_next(hist, eps, cur, 1024) == \
            radaptive._secant_next(hist, eps, cur, 1024)
    assert adaptive.resolve_bars(None, 0.5) == radaptive.resolve_bars(None,
                                                                      0.5)
    for s, g in (("auto", 0.0), ("auto", 0.2), (False, 0.0), (True, 0.0)):
        assert adaptive.resolve_sprint(s, g) == radaptive.resolve_sprint(s, g)
    with pytest.raises(ValueError):
        adaptive.resolve_sprint(True, 0.2)
    c = adaptive.certificate_from_trajectory((1, 9, 17), (5.0, 2.0, 1.0), 8,
                                             eps=1.0, b_schedule=((8, 2),))
    r = radaptive.certificate_from_trajectory((1, 9, 17), (5.0, 2.0, 1.0), 8,
                                              eps=1.0, b_schedule=((8, 2),))
    assert c.to_dict() == r.to_dict()


def test_grouped_adaptive_is_a_later_slice():
    """The grouped (m > 1) loop came with the constrained slice: it now runs
    and keeps each group's picks inside the group; the MapReduce planner
    (``resolve_engine_plan``) came with the MapReduce slice."""
    pts = torch.as_tensor(_normal(64, 2, 3))
    labels = torch.as_tensor(np.arange(64) % 2, dtype=torch.int32)
    run = adaptive.adaptive_select(pts, labels, [0, 1], 2, 4,
                                   group_counts=[32, 32], device="cpu")
    assert run.idx.shape == (2, 4)
    assert np.all(run.idx % 2 == np.arange(2)[:, None])
    assert callable(adaptive.resolve_engine_plan)
