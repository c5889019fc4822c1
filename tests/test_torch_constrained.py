"""Port parity for the constrained engine (``repro_torch.constrained``) on the
CPU: the grouped selection engine (b = 1 and b > 1) against the reference's
with its Pallas kernel (interpret mode) and without; the adaptive grouped
builder host-paced, in sprint, through the b = 1 resume and with auto-k'
milestones; the delegates pass; the solver against the exact optimum; the
per-group streaming core-set.

Tolerances: picks and executed schedules are compared exactly (on the valid
core-set slots only: both packages fill the tail of a group smaller than k'
with repeats or arbitrary rows), except where a deep b = 1 tail on
clustered data meets a near-tie (two rows equally far to rtol 1e-4), where
the runs may part; radii, ratios and certificate floats to
rtol 1e-4, the reference's end-to-end parity (XLA and torch sum dot
products in another order).  Two stated exceptions: a group whose rows are
all centers has radius 0 up to the factorized euclidean form's rounding
(sqrt of a residual of ~1e-7·||x||², so atol 2e-3 on radii of 4-d normal
data), and on clustered data the same form cancels where ||x||² ≫ r², so
the radii there agree to the repo's clustered rtol of 2e-3
(tests/test_torch_adaptive.py).  Inside the port, sprint must be
bit-identical to host pacing.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.constrained import coreset as rcs
from repro.constrained import solver as rsolver
from repro.constrained import streaming as rstream
from repro.constrained.matroid import PartitionMatroid as RPM
from repro.core.gmm import pad_for_engine
from repro_torch import obs
from repro_torch.constrained import coreset as pcs
from repro_torch.constrained import solver as psolver
from repro_torch.constrained import streaming as pstream
from repro_torch.constrained.matroid import PartitionMatroid as PM
pgmm = importlib.import_module("repro_torch.core.gmm")

RTOL = 1e-4
CLUSTERED_RTOL = 2e-3
SELF_ATOL = 2e-3


def _labelled(n, m, seed, dim=4, tiny_group=True):
    """Normal points; skewed group sizes, group m-1 holding 3 rows (fewer
    than the engine's block) when ``tiny_group``."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, dim)).astype(np.float32)
    w = 1.0 / np.arange(1, m + 1)
    lab = rng.choice(m, size=n, p=w / w.sum()).astype(np.int32)
    if tiny_group:
        lab[lab == m - 1] = 0
        lab[rng.choice(n, 3, replace=False)] = m - 1
    return pts, lab


def _valid_rows(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [idx[g][valid[g]].tolist() for g in range(idx.shape[0])]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_grouped_select_matches_reference(metric, b, use_pallas):
    n, m, kp = 1500, 4, 16
    pts, lab = _labelled(n, m, 3)
    pp, ll, ch = pad_for_engine(jnp.asarray(pts), jnp.asarray(lab), 0)
    r_idx, r_valid, r_rad, r_cnt, _ = rcs._grouped_select_impl(
        pp, ll, m, kp, b, ch, metric, use_pallas)
    g_idx, g_valid, g_rad, g_cnt, g_md = pcs._grouped_select_impl(
        torch.as_tensor(pts), torch.as_tensor(lab), m, kp, b, 0, metric,
        False)
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(g_cnt.numpy(), np.asarray(r_cnt))
    assert _valid_rows(g_idx, g_valid) == _valid_rows(r_idx, r_valid)
    np.testing.assert_allclose(g_rad.numpy(), np.asarray(r_rad), rtol=RTOL,
                               atol=SELF_ATOL if metric == "euclidean" else 0)
    assert g_md.shape == (n,)
    for g, rows in enumerate(_valid_rows(g_idx, g_valid)):
        assert np.all(lab[rows] == g) and len(set(rows)) == len(rows)


def test_vectorized_inblock_equals_a_loop_over_groups():
    """One (m, p) pick step for all groups gives each group's picks as a
    run of that group alone would, bit for bit."""
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.normal(size=(400, 6)).astype(np.float32))
    for metric in ("euclidean", "sqeuclidean", "cosine", "manhattan"):
        cand_i = torch.as_tensor(rng.choice(400, size=(5, 24)))
        cand_d = torch.as_tensor(rng.uniform(0.5, 3.0, size=(5, 24))
                                 .astype(np.float32))
        cand_d[4, 20:] = float("-inf")                  # a short pool
        chosen, seld = pgmm._grouped_inblock(pts, metric, cand_d, cand_i, 6)
        for g in range(5):
            c1, s1 = pgmm._grouped_inblock(pts, metric, cand_d[g:g + 1],
                                           cand_i[g:g + 1], 6)
            assert torch.equal(chosen[g], c1[0]), metric
            np.testing.assert_allclose(seld[g].numpy(), s1[0].numpy(),
                                       rtol=1e-6, atol=1e-6)


def _assert_same_picks_up_to_ties(got, want, pts):
    """Per group, the same picks; where a deep b = 1 tail meets a near-tie
    (two rows equally far, to the end-to-end rtol, from the picks before
    them — the two packages round the factorized distance differently),
    the runs may part there and only the prefix is compared."""
    for g_rows, w_rows in zip(got, want):
        assert len(g_rows) == len(w_rows)
        for j, (a, b) in enumerate(zip(g_rows, w_rows)):
            if a == b:
                continue
            prefix = pts[g_rows[:j]].astype(np.float64)
            da = np.linalg.norm(prefix - pts[a], axis=1).min()
            db = np.linalg.norm(prefix - pts[b], axis=1).min()
            np.testing.assert_allclose(da, db, rtol=RTOL)
            break


def _adaptive_pair(pts, lab, m, k, kprime, **kw):
    want = rcs.grouped_adaptive(jnp.asarray(pts), jnp.asarray(lab), m, k,
                                kprime, use_pallas=False, **kw)
    tr = obs.RunTrace(enabled=True)
    with obs.activate(tr):
        got = pcs.grouped_adaptive(torch.as_tensor(pts), lab, m, k, kprime,
                                   device="cpu", **kw)
    return want, got, tr


def _assert_certs_close(g, w, rtol=RTOL):
    assert g.counts == w.counts and g.b_schedule == w.b_schedule
    assert g.kprime == w.kprime and g.meets_target == w.meets_target
    np.testing.assert_allclose(g.radii, w.radii, rtol=rtol)
    np.testing.assert_allclose((g.radius, g.scale, g.ratio),
                               (w.radius, w.scale, w.ratio), rtol=rtol)
    np.testing.assert_allclose(g.group_ratios, w.group_ratios, rtol=rtol)


@pytest.mark.parametrize("kprime,sprint", [(32, False), (32, True),
                                           ("auto", "auto")])
def test_grouped_adaptive_matches_reference(kprime, sprint):
    """Host-paced, sprint and auto-k' (milestones over per-group counts):
    the same picks, executed schedule and per-group certificate."""
    pts, lab = _labelled(2000, 3, 5)
    want, got, _ = _adaptive_pair(pts, lab, 3, 4, kprime, sprint=sprint)
    _assert_certs_close(got.cert, want.cert)
    assert _valid_rows(got.idx, got.valid) == _valid_rows(want.idx,
                                                         want.valid)
    np.testing.assert_array_equal(got.group_count.numpy(),
                                  np.asarray(want.group_count))
    np.testing.assert_allclose(got.radius.numpy(), np.asarray(want.radius),
                               rtol=RTOL, atol=SELF_ATOL)


def test_grouped_adaptive_resume_path_matches_reference():
    """Clustered groups drive the controller to single picks, so the run
    ends in the exact b = 1 resume; the host-paced counters equal the
    reference's."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, 3)) * 2.0
    pts = (centers[rng.integers(0, 6, 2400)]
           + rng.normal(size=(2400, 3)) * 0.05).astype(np.float32)
    lab = rng.integers(0, 2, size=2400).astype(np.int32)
    want, got, tr = _adaptive_pair(pts, lab, 2, 4, 40, b=8, sprint=False)
    assert any(bsz == 1 for bsz, _ in got.cert.b_schedule)
    _assert_certs_close(got.cert, want.cert)
    _assert_same_picks_up_to_ties(_valid_rows(got.idx, got.valid),
                                  _valid_rows(want.idx, want.valid), pts)
    from repro import obs as robs
    rt = robs.RunTrace(enabled=True)
    with robs.activate(rt):
        rcs.grouped_adaptive(jnp.asarray(pts), jnp.asarray(lab), 2, 4, 40,
                             b=8, sprint=False, use_pallas=False)
    for key in ("device_dispatches", "host_syncs", "distance_evals",
                "bytes_swept", "pool_widenings"):
        assert tr.counters.get(key, 0) == rt.counters.get(key, 0), key


@pytest.mark.parametrize("data", ["normal", "clustered"])
def test_grouped_sprint_is_bit_identical_inside_the_port(data):
    rng = np.random.default_rng(4)
    if data == "normal":
        pts = rng.normal(size=(2000, 6)).astype(np.float32)
    else:
        c = rng.normal(size=(20, 6)) * 10
        pts = (c[rng.integers(0, 20, 2000)]
               + rng.normal(size=(2000, 6)) * 0.1).astype(np.float32)
    lab = rng.integers(0, 3, size=2000).astype(np.int32)
    runs, counters = {}, {}
    for sprint in (False, True):
        tr = obs.RunTrace(enabled=True)
        with obs.activate(tr):
            runs[sprint] = pcs.grouped_adaptive(torch.as_tensor(pts), lab, 3,
                                                6, 96, sprint=sprint,
                                                device="cpu")
        counters[sprint] = dict(tr.counters)
    host, fast = runs[False], runs[True]
    assert counters[False].get("sprint_segments", 0) == 0
    if data == "normal":
        assert counters[True]["sprint_segments"] >= 1
    for key in ("distance_evals", "bytes_swept"):
        assert counters[True][key] == counters[False][key]
    assert torch.equal(host.idx, fast.idx)
    assert torch.equal(host.radius, fast.radius)
    assert host.cert == fast.cert


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_delegates_pass_matches_reference(metric):
    n, m, k, kp = 1200, 3, 3, 8
    pts, lab = _labelled(n, m, 9)
    pp, ll, ch = pad_for_engine(jnp.asarray(pts), jnp.asarray(lab), 500)
    r_idx = rcs._grouped_select_impl(pp, ll, m, kp, 1, ch, metric,
                                     False)[0]
    r_didx, r_dvalid = rcs._grouped_delegates_impl(pp, ll, r_idx, m, k, kp,
                                                   ch, metric)
    g_didx, g_dvalid, _ = pcs._grouped_delegates_impl(
        torch.as_tensor(pts), torch.as_tensor(lab),
        torch.as_tensor(np.array(r_idx), dtype=torch.int64), m, k, kp, 500,
        metric, False)
    np.testing.assert_array_equal(g_dvalid.numpy(), np.asarray(r_dvalid))
    assert _valid_rows(g_didx, g_dvalid) == _valid_rows(r_didx, r_dvalid)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique",
                                     "remote-star"])
@pytest.mark.parametrize("seed", [0, 1])
def test_solver_finds_the_exact_optimum_on_small_inputs(measure, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(10, 2)).astype(np.float32)
    lab = rng.integers(0, 2, size=10)
    lab[:2] = [0, 1]
    mat, rmat = PM([2, 1]), RPM([2, 1])
    g_val, g_idx = psolver.brute_force_constrained(pts, lab, measure=measure,
                                                   matroid=mat)
    w_val, w_idx = rsolver.brute_force_constrained(pts, lab, measure=measure,
                                                   matroid=rmat)
    np.testing.assert_allclose(g_val, w_val, rtol=RTOL)
    assert sorted(g_idx.tolist()) == sorted(w_idx.tolist())
    sel, val = psolver.solve_and_value(pts, lab, measure=measure,
                                       matroid=mat)
    r_sel, r_val = rsolver.solve_and_value(pts, lab, measure=measure,
                                           matroid=rmat)
    assert sorted(sel.tolist()) == sorted(g_idx.tolist()) == \
        sorted(r_sel.tolist())
    # remote-star sums rows of the distance matrix, the diagonal's
    # rounding-size self-distances included (SELF_ATOL covers them)
    np.testing.assert_allclose(val, r_val, rtol=RTOL,
                               atol=SELF_ATOL if measure == "remote-star"
                               else 0)
    # the greedy + swap path on the same distances answers as the
    # reference's does
    sel_g = psolver.constrained_solve(pts, lab, measure=measure, matroid=mat,
                                      exact_limit=0)
    sel_r = rsolver.constrained_solve(pts, lab, measure=measure,
                                      matroid=rmat, exact_limit=0)
    assert sel_g.tolist() == sel_r.tolist()
    assert np.bincount(lab[sel_g], minlength=2).tolist() == [2, 1]


@pytest.mark.parametrize("mode", ["plain", "ext"])
def test_fair_streaming_coreset_matches_reference(mode):
    pts, lab = _labelled(600, 3, 11, tiny_group=False)
    want = rstream.FairStreamingCoreset(m=3, k=4, kprime=12, dim=4,
                                        mode=mode)
    got = pstream.FairStreamingCoreset(m=3, k=4, kprime=12, dim=4,
                                       mode=mode, device="cpu")
    for s in range(0, 600, 300):
        want.update(pts[s:s + 300], lab[s:s + 300])
        got.update(torch.as_tensor(pts[s:s + 300]), lab[s:s + 300])
    w_pts, w_lab = want.finalize()
    g_pts, g_lab = got.finalize()
    np.testing.assert_array_equal(g_lab, w_lab)
    np.testing.assert_array_equal(g_pts.numpy(), w_pts)
    assert got.n_seen == want.n_seen == 600
    np.testing.assert_allclose(got.radius, want.radius, rtol=1e-5)
    wc, gc = want.certificate(), got.certificate()
    np.testing.assert_allclose(gc.group_ratios, wc.group_ratios, rtol=RTOL)
    np.testing.assert_allclose((gc.radius, gc.scale, gc.ratio),
                               (wc.radius, wc.scale, wc.ratio), rtol=RTOL)
    assert gc.counts == wc.counts and gc.kind == "streaming"


def test_fair_stream_rejects_bad_labels_and_gen():
    got = pstream.FairStreamingCoreset(m=2, k=2, kprime=4, dim=2,
                                       device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        got.update(np.zeros((3, 2), np.float32), [0, 2, 1])
    with pytest.raises(ValueError, match="rows"):
        got.update(np.zeros((3, 2), np.float32), [0, 1])
    with pytest.raises(ValueError, match="keeps points"):
        pstream.FairStreamingCoreset(m=2, k=2, kprime=4, dim=2, mode="gen",
                                     device="cpu")


def test_grouped_coreset_fixed_knobs_and_counters_match_reference():
    from repro import obs as robs
    pts, lab = _labelled(1000, 3, 13)
    rt = robs.RunTrace(enabled=True)
    with robs.activate(rt):
        want = rcs.grouped_coreset(jnp.asarray(pts), jnp.asarray(lab), 3, 4,
                                   16, b=4, measure="remote-clique")
    tr = obs.RunTrace(enabled=True)
    with obs.activate(tr):
        got = pcs.grouped_coreset(pts, lab, 3, 4, 16, b=4,
                                  measure="remote-clique", device="cpu")
    # the same delegate rows per group; in a group smaller than k' the
    # kernel repeats its rows, and which repeated slot a row's delegates
    # land in follows rounding-size self-distances, so the slot order there
    # is compared as a set
    assert [sorted(r) for r in _valid_rows(got.idx, got.valid)] == \
        [sorted(r) for r in _valid_rows(want.idx, want.valid)]
    assert _valid_rows(got.idx, got.valid)[:2] == _valid_rows(
        want.idx, want.valid)[:2]
    assert got.size == want.size
    c, l = got.flatten()
    rc, rl = want.flatten()
    assert sorted(zip(l.tolist(), c.tolist())) == sorted(
        zip(rl.tolist(), np.asarray(rc).tolist()))
    want_c = dict(rt.counters)
    want_c.pop("jit_recompiles", None)
    assert dict(tr.counters) == want_c
