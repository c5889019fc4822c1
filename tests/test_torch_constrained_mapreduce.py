"""Port parity for the simulated constrained MapReduce run
(``repro_torch.constrained.mapreduce``) on the CPU: round 1 of all
reducers as one grouped-engine run over the ℓ·m groups reducer · m + label,
against the reference's vmap of one grouped core-set per shard; and the
whole run (``_simulate_fair_mr_impl`` and the facade) with quotas and a
matroid, plain and EXT, every partition.

The port runs its plain torch path (``device="cpu"``).  The union's rows,
labels and validity, the solution rows and labels, the certificate's
counts and schedule and the counters must be equal (``host_syncs`` only
with pinned knobs: the probe runs sprint "auto" in both packages, and the
port reads one flag per sprint round); radii, values and certificate
floats to rtol 1e-4, the reference's end-to-end parity.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.constrained import mapreduce as rcmr
from repro.constrained import matroid as rmat
from repro.core import distributed as rdist
from repro_torch.constrained import mapreduce as pcmr
from repro_torch.constrained import matroid as pmat
from repro_torch.core import distributed as pdist

RTOL = 1e-4


def _data(n=1600, d=4, m=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    w = np.array([0.6, 0.3, 0.1])[:m]
    lab = rng.choice(m, size=n, p=w / w.sum()).astype(np.int32)
    return pts, lab


@pytest.mark.parametrize("mode,b,schedule", [
    ("plain", 1, None), ("plain", 4, None), ("plain", 1, ((4, 2), (1, 4))),
    ("ext", 1, None), ("ext", 4, None)])
@pytest.mark.parametrize("partition", ["contiguous", "random"])
def test_round1_equals_reference(mode, b, schedule, partition):
    pts, lab = _data()
    ell, m, k, kp = 4, 3, 4, 12
    _, r_shards, r_lab = rdist.partition_shards(pts, ell, partition=partition,
                                                seed=2, labels=lab)
    w_pts, w_lab, w_valid, w_rad = rcmr._sim_round1(
        r_shards, r_lab, m, k, kp, "euclidean", mode, b, 0, schedule)
    g_all, _, g_slab = pdist.partition_shards(
        pts, ell, partition=partition, seed=2, labels=lab, device="cpu")
    g_pts, g_lab, g_valid, g_rad = pcmr._sim_round1(
        g_all, g_slab, m, k, kp, "euclidean", mode, b, 0, schedule,
        use_pallas=False)
    w_valid = np.asarray(w_valid)
    np.testing.assert_array_equal(g_valid.numpy(), w_valid)
    np.testing.assert_array_equal(g_lab.numpy(), np.asarray(w_lab))
    np.testing.assert_array_equal(g_pts.numpy()[w_valid],
                                  np.asarray(w_pts)[w_valid])
    np.testing.assert_allclose(g_rad.numpy(), np.asarray(w_rad), rtol=RTOL)


def test_round1_small_groups_and_a_missing_group():
    """A shard without group 2 and groups smaller than k': the empty group
    contributes nothing, a small group only its own rows."""
    pts, lab = _data(600, 3, seed=4)
    lab[:300] = np.where(lab[:300] == 2, 0, lab[:300])     # shard 0: no 2s
    lab[300:] = np.where(lab[300:] == 2, 2, 1)
    lab[300:590] = 1
    _, r_shards, r_lab = rdist.partition_shards(pts, 2, labels=lab)
    want = rcmr._sim_round1(r_shards, r_lab, 3, 4, 16, "euclidean", "plain")
    g_all, _, g_slab = pdist.partition_shards(pts, 2, labels=lab,
                                              device="cpu")
    got = pcmr._sim_round1(g_all, g_slab, 3, 4, 16, "euclidean", "plain",
                           use_pallas=False)
    valid = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid])
    assert valid[0, 32:].sum() == 0                   # shard 0, group 2
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)


def _oracles(kind):
    if kind == "quotas":
        return dict(quotas=[2, 2, 2]), dict(quotas=[2, 2, 2])
    args = dict(q_min=[1, 1, 0], q_max=[3, 3, 2], k=6)
    return (dict(matroid=pmat.PartitionMatroid(**args)),
            dict(matroid=rmat.PartitionMatroid(**args)))


@pytest.mark.parametrize("kind", ["quotas", "ranged"])
@pytest.mark.parametrize("measure,b,partition", [
    ("remote-edge", 1, "contiguous"), ("remote-edge", 4, "random"),
    ("remote-clique", 1, "adversarial"), ("remote-clique", 2, "random")])
def test_simulate_fair_mr_impl_equals_reference(kind, measure, b, partition):
    pts, lab = _data(seed=5)
    p_kw, r_kw = _oracles(kind)
    kw = dict(num_reducers=4, measure=measure, kprime=8, partition=partition,
              seed=3, b=b)
    w_sol, w_lab, w_val, w_cert, _ = rcmr._simulate_fair_mr_impl(
        pts, lab, **r_kw, **kw)
    g_sol, g_lab, g_val, g_cert, _ = pcmr._simulate_fair_mr_impl(
        torch.as_tensor(pts), lab, **p_kw, device="cpu", **kw)
    np.testing.assert_array_equal(g_sol.numpy(), np.asarray(w_sol))
    np.testing.assert_array_equal(g_lab, np.asarray(w_lab))
    np.testing.assert_allclose(g_val, w_val, rtol=RTOL)
    assert g_cert is None and w_cert is None


def _both(pts, lab, k, measure="remote-edge", **kw):
    want = repro.diversify(pts, k=k, measure=measure, labels=lab,
                           execution=repro.ExecutionSpec(
                               mode="mapreduce", trace=True, **kw))
    got = repro_torch.diversify(pts, k=k, measure=measure, labels=lab,
                                execution=repro_torch.ExecutionSpec(
                                    mode="mapreduce", device="cpu",
                                    trace=True, **kw))
    return want, got


@pytest.mark.parametrize("measure,knobs", [
    ("remote-edge", dict(kprime=16, b=1)),
    ("remote-edge", dict()),
    ("remote-clique", dict(kprime=8, b="auto")),
    ("remote-edge", dict(kprime="auto", b=1, partition="random"))])
def test_facade_labels_alone(measure, knobs):
    pts, lab = _data(seed=6)
    want, got = _both(pts, lab, 6, measure, num_reducers=4, **knobs)
    np.testing.assert_array_equal(got.solution, want.solution)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(lab[got.indices], got.labels)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert got.plan.explain() == want.plan.explain()
    pinned = knobs.get("b", "auto") != "auto" and \
        knobs.get("kprime", "auto") != "auto"
    gc, wc = dict(got.telemetry.counters), dict(want.telemetry.counters)
    wc.pop("jit_recompiles", None)
    if not pinned:
        gc.pop("host_syncs", None)
        wc.pop("host_syncs", None)
    assert gc == wc
    assert (got.cert is None) == (want.cert is None)
    if want.cert is not None:
        assert got.cert.b_schedule == want.cert.b_schedule
        assert got.cert.counts == want.cert.counts
        np.testing.assert_allclose(got.cert.ratio, want.cert.ratio,
                                   rtol=RTOL)


def test_facade_transversal_matroid():
    pts, lab = _data(seed=7)
    elig = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]], bool)
    want = repro.diversify(pts, k=4, labels=lab,
                           matroid=rmat.TransversalMatroid(elig),
                           execution=repro.ExecutionSpec(
                               mode="mapreduce", num_reducers=2, kprime=12,
                               b=1))
    got = repro_torch.diversify(pts, k=4, labels=lab,
                                matroid=pmat.TransversalMatroid(elig),
                                execution=repro_torch.ExecutionSpec(
                                    mode="mapreduce", num_reducers=2,
                                    kprime=12, b=1, device="cpu"))
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL)
    assert got.plan.explain() == want.plan.explain()


def test_legacy_simulate_fair_mr_warns_and_answers():
    pts, lab = _data(seed=8)
    with pytest.warns(DeprecationWarning):
        sol, sl, val = pcmr.simulate_fair_mr(pts, lab, [2, 2, 2],
                                             num_reducers=3, kprime=8,
                                             device="cpu")
    with pytest.warns(DeprecationWarning):
        rsol, rsl, rval = rcmr.simulate_fair_mr(pts, lab, [2, 2, 2],
                                                num_reducers=3, kprime=8)
    np.testing.assert_array_equal(sol, rsol)
    np.testing.assert_array_equal(sl, rsl)
    np.testing.assert_allclose(val, rval, rtol=RTOL)


def test_fair_coreset_interop():
    from repro_torch.interop import from_reference, to_numpy
    pts, lab = _data(200, 3, seed=9)
    valid = np.arange(200) % 3 != 0
    ref = rcmr.FairCoreset(points=pts, labels=lab, valid=valid,
                           radius=np.float32(0.5))
    ported = from_reference(ref, device="cpu")
    assert isinstance(ported, pcmr.FairCoreset)
    cp, cl = ported.compact()
    rp, rl = ref.compact()
    np.testing.assert_array_equal(cp.numpy(), rp)
    np.testing.assert_array_equal(cl, rl)
    assert ported.size == ref.size
    back = to_numpy(ported)
    np.testing.assert_array_equal(back["valid"], valid)
