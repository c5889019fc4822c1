"""Port parity for the simulated MapReduce building blocks on the CPU:
``core.distributed`` (the reducer partition, round 1 as one grouped-engine
run with labels = reducer id, the model counters), the probe that freezes
``b="auto"`` / ``kprime="auto"`` into a reducer schedule
(``core.adaptive.plan_from_schedule`` / ``resolve_engine_plan``) and the
δ-instantiation (``core.sequential.instantiate``), each against the
reference function on the same numpy inputs.

The reference runs as its own tests run it on the CPU: its simulated round
1 is the lax path (``use_pallas=False`` is fixed there).  The port runs its
plain torch path (``device="cpu"``), whose arithmetic is the kernels'.

Tolerances: the partition, the executed schedules, counts and counters are
compared exactly; per-reducer picks are compared exactly except where a
deep b = 1 tail meets a near-tie (two rows equally far, to the end-to-end
rtol 1e-4, from the picks before them: the packages round the factorized
distance differently), where only the prefix is compared; radii and
certificate floats to rtol 1e-4, the reference's end-to-end parity.
``instantiate`` keeps a pool point when its distance is at most
``radius·(1 + 1e-6)``: both packages compute that distance in fp32 to a
few ulp of each other, so only a pool point within a few ulp of the
threshold could part them; the tests prove that no point of the fixtures
lies there before they require equal outputs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import obs as robs
from repro.core import adaptive as radp
from repro.core import distributed as rdist
from repro.core import sequential as rseq
from repro_torch import obs as pobs
from repro_torch.core import adaptive as padp
from repro_torch.core import sequential as pseq
pdist = importlib.import_module("repro_torch.core.distributed")
rgmm = importlib.import_module("repro.core.gmm")

RTOL = 1e-4


def _data(n=2000, d=8, seed=0, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(6, d)) * 3.0
        return (centers[rng.integers(0, 6, n)]
                + rng.normal(size=(n, d)) * 0.1).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _gmm_radius64(shard, picks):
    """float64 radius of ``picks`` over ``shard``; asserts each pick after
    the first is a farthest shard row (rtol 1e-4) from the picks before."""
    shard, picks = shard.astype(np.float64), picks.astype(np.float64)
    near = np.linalg.norm(shard - picks[0], axis=1)
    for j in range(1, picks.shape[0]):
        got = np.linalg.norm(picks[:j] - picks[j], axis=1).min()
        np.testing.assert_allclose(got, near.max(), rtol=RTOL)
        near = np.minimum(near, np.linalg.norm(shard - picks[j], axis=1))
    return near.max()


def assert_same_rows_up_to_ties(got, want, shard):
    """Rows of one reducer's exact (b = 1) picks (k', d) equal; where they
    first part, the two rows are a near-tie, equally far (rtol 1e-4) from
    the picks before, and from there on each package's picks are a GMM run
    of their own on ``shard``.  Returns the row where they part, or
    None."""
    for j in range(got.shape[0]):
        if np.array_equal(got[j], want[j]):
            continue
        prefix = want[:j].astype(np.float64)
        da = np.linalg.norm(prefix - got[j], axis=1).min()
        db = np.linalg.norm(prefix - want[j], axis=1).min()
        np.testing.assert_allclose(da, db, rtol=RTOL)
        _gmm_radius64(shard, got)
        _gmm_radius64(shard, want)
        return j
    return None


# --------------------------------------------------------------------------
# partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["contiguous", "random", "adversarial"])
@pytest.mark.parametrize("n,ell", [(2000, 4), (1999, 8), (37, 5)])
def test_partition_shards_equals_reference(partition, n, ell):
    pts = _data(n, 3, seed=n)
    lab = np.random.default_rng(1).integers(0, 3, size=n).astype(np.int32)
    r_pts, r_shards, r_lab = rdist.partition_shards(
        pts, ell, partition=partition, seed=7, labels=lab)
    g_pts, g_shards, g_lab = pdist.partition_shards(
        pts, ell, partition=partition, seed=7, labels=lab, device="cpu")
    np.testing.assert_array_equal(g_pts.numpy(), r_pts)
    np.testing.assert_array_equal(g_shards.numpy(), np.asarray(r_shards))
    np.testing.assert_array_equal(g_lab.numpy(), np.asarray(r_lab))
    per = -(-n // ell)
    assert g_shards.shape == (ell, per, 3)
    # padding repeats leading rows: every padded row is an input row
    assert {tuple(r) for r in g_pts.numpy()} == {tuple(r) for r in pts}


# --------------------------------------------------------------------------
# probe -> static plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("executed,kprime,probe_k", [
    ((), 64, 10), (((1, 40),), 64, 40), (((8, 3), (1, 7)), 64, 31),
    (((8, 5),), 40, 40), (((8, 1), (4, 2), (1, 9)), 100, 25),
    (((16, 2), (1, 60)), 20, 93), (((8, 8),), 12, 64)])
def test_plan_from_schedule_equals_reference(executed, kprime, probe_k):
    assert (padp.plan_from_schedule(executed, kprime, probe_k)
            == radp.plan_from_schedule(executed, kprime, probe_k))


def _certs_close(g, w):
    assert (g is None) == (w is None)
    if w is None:
        return
    assert g.kprime == w.kprime and g.counts == w.counts
    assert g.b_schedule == w.b_schedule and g.meets_target == w.meets_target
    np.testing.assert_allclose(g.radii, w.radii, rtol=RTOL)
    np.testing.assert_allclose((g.radius, g.scale, g.ratio),
                               (w.radius, w.scale, w.ratio), rtol=RTOL)


@pytest.mark.parametrize("kprime,b,labelled", [
    ("auto", "auto", False), (48, "auto", False), ("auto", 1, False),
    ("auto", "auto", True), (24, 4, False)])
def test_resolve_engine_plan_equals_reference(kprime, b, labelled):
    pts = _data(3000, 4, seed=2)
    lab = (np.random.default_rng(3).integers(0, 3, 3000).astype(np.int32)
           if labelled else None)
    kw = dict(eps=0.2, metric="euclidean", labels=lab, m=3, sample=1024,
              sprint=False)
    rt, pt = robs.RunTrace(enabled=True), pobs.RunTrace(enabled=True)
    with robs.activate(rt):
        want = radp.resolve_engine_plan(pts, 6, kprime, b, **kw)
    with pobs.activate(pt):
        got = padp.resolve_engine_plan(torch.as_tensor(pts), 6, kprime, b,
                                       device="cpu", **kw)
    assert got[:2] == want[:2]
    _certs_close(got[2], want[2])
    # the host-paced probe's work and host reads equal the reference's
    rc = dict(rt.counters)
    rc.pop("jit_recompiles", None)
    assert dict(pt.counters) == rc


# --------------------------------------------------------------------------
# round 1
# --------------------------------------------------------------------------

def _round1_pair(pts, ell, k, kprime, mode, b=1, schedule=None,
                 metric="euclidean", partition="contiguous"):
    r_pts, r_shards, _ = rdist.partition_shards(pts, ell,
                                                partition=partition, seed=1)
    want = rdist._sim_round1(r_shards, k, kprime, metric, mode, b, 0,
                             schedule)
    g_pts, _, _ = pdist.partition_shards(pts, ell, partition=partition,
                                         seed=1, device="cpu")
    got = pdist._sim_round1(g_pts, ell, k, kprime, metric, mode, b, 0,
                            schedule, use_pallas=False)
    return r_shards, want, got


@pytest.mark.parametrize("b,schedule", [(1, None), (4, None),
                                        (1, ((4, 5), (1, 12)))])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_round1_plain_equals_reference(b, schedule, metric):
    pts = _data()
    shards, (w_pts, w_valid, w_rad), (g_pts, g_valid, g_rad) = _round1_pair(
        pts, 4, 6, 32, "plain", b, schedule, metric)
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))
    for r in range(4):
        assert assert_same_rows_up_to_ties(
            g_pts[r].numpy(), np.asarray(w_pts[r]),
            np.asarray(shards[r])) is None
    np.testing.assert_allclose(g_rad.numpy(), np.asarray(w_rad), rtol=RTOL)


def test_round1_plain_clustered_deep_tail_up_to_ties():
    """Clustered data and a long exact b = 1 tail: picks equal up to proven
    near-ties.  A reducer whose picks match holds its radius to the
    reference's; one whose picks part after a tie holds it to the float64
    radius of its own picks (each to rtol 1e-4)."""
    pts = _data(2000, 3, seed=5, clustered=True)
    shards, (w_pts, _, w_rad), (g_pts, _, g_rad) = _round1_pair(
        pts, 2, 4, 64, "plain", partition="random")
    for r in range(2):
        shard = np.asarray(shards[r])
        parted = assert_same_rows_up_to_ties(
            g_pts[r].numpy(), np.asarray(w_pts[r]), shard)
        want = (np.asarray(w_rad)[r] if parted is None
                else _gmm_radius64(shard, g_pts[r].numpy()))
        np.testing.assert_allclose(float(g_rad[r]), want, rtol=RTOL)


@pytest.mark.parametrize("b", [1, 4])
def test_round1_ext_equals_reference(b):
    pts = _data(seed=4)
    _, (w_pts, w_valid, w_rad), (g_pts, g_valid, g_rad) = _round1_pair(
        pts, 4, 5, 16, "ext", b, partition="random")
    w_valid = np.asarray(w_valid)
    np.testing.assert_array_equal(g_valid.numpy(), w_valid)
    np.testing.assert_array_equal(g_pts.numpy()[w_valid],
                                  np.asarray(w_pts)[w_valid])
    np.testing.assert_allclose(g_rad.numpy(), np.asarray(w_rad), rtol=RTOL)


def test_round1_gen_multiplicities_equal_reference():
    pts = _data(seed=6)
    shards, (w_pts, w_pos, w_rad), (g_pts, g_mult, g_rad) = _round1_pair(
        pts, 4, 5, 16, "gen", partition="adversarial")
    np.testing.assert_array_equal(g_pts.numpy(), np.asarray(w_pts))
    np.testing.assert_array_equal(g_mult.numpy() > 0, np.asarray(w_pos))
    for r in range(4):
        ref = rgmm.gmm_gen(shards[r], 5, 16, metric="euclidean")
        np.testing.assert_array_equal(g_mult[r].numpy(),
                                      np.asarray(ref.multiplicity))
    np.testing.assert_allclose(g_rad.numpy(), np.asarray(w_rad), rtol=RTOL)


def test_round1_is_one_grouped_run_with_a_seed_per_reducer():
    """Labels = reducer id, each reducer seeded at its shard's first row: a
    reducer's picks stay in its own shard."""
    pts = _data(1200, 4, seed=8)
    g_pts, _, _ = pdist.partition_shards(pts, 3, device="cpu")
    lab, starts = pdist._reducer_labels(3, 400, torch.device("cpu"))
    assert lab.tolist() == [0] * 400 + [1] * 400 + [2] * 400
    assert starts.tolist() == [0, 400, 800]
    out, _, _ = pdist._sim_round1(g_pts, 3, 4, 16, "euclidean", "plain",
                                  use_pallas=False)
    for r in range(3):
        shard = {tuple(x) for x in pts[400 * r:400 * (r + 1)]}
        assert all(tuple(x) in shard for x in out[r].numpy())
        np.testing.assert_array_equal(out[r, 0].numpy(), pts[400 * r])


# --------------------------------------------------------------------------
# model counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,schedule,mode", [
    (1, None, "plain"), (4, None, "plain"), (6, None, "plain"),
    (1, ((4, 3), (1, 4)), "plain"), (1, None, "ext"), (4, None, "ext"),
    (1, ((8, 2),), "gen"), ("auto", None, "gen")])
def test_count_round1_equals_reference(b, schedule, mode):
    rt, pt = robs.RunTrace(enabled=True), pobs.RunTrace(enabled=True)
    with robs.activate(rt):
        rdist._count_round1(4, 500, 8, 16, b, schedule, mode)
    with pobs.activate(pt):
        pdist._count_round1(4, 500, 8, 16, b, schedule, mode)
    assert dict(pt.counters) == dict(rt.counters)
    assert pt.counters["distance_evals"] > 0


# --------------------------------------------------------------------------
# δ-instantiation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_instantiate_equals_reference(metric):
    pool = _data(800, 5, seed=9)
    rng = np.random.default_rng(10)
    kern = pool[rng.choice(800, 6, replace=False)]
    counts = np.array([1, 3, 2, 4, 1, 2])
    dm = np.asarray(rdist.get_metric(metric).pairwise(jnp.asarray(kern),
                                                      jnp.asarray(pool)))
    radius = float(np.quantile(dm, 0.01))
    # no pool point sits within a few ulp of the threshold, where the two
    # packages' fp32 distances could fall on opposite sides of it
    thr = np.float32(radius * (1 + 1e-6))
    assert np.abs(dm - thr).min() > 8 * np.spacing(thr)
    want = rseq.instantiate(kern, counts, pool, radius, metric=metric)
    got = pseq.instantiate(torch.as_tensor(kern), counts,
                           torch.as_tensor(pool), radius, metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)


def test_instantiate_falls_back_to_replicas():
    pool = _data(50, 3, seed=11)
    kern = pool[:2] + 10.0                       # far from every pool row
    got = pseq.instantiate(torch.as_tensor(kern), [2, 1],
                           torch.as_tensor(pool), 0.5)
    want = rseq.instantiate(kern, np.array([2, 1]), pool, 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kern[[0, 0, 1]])
