"""Port parity for ``core.gmm``: exact b=1 GMM, the schedule engine,
GMM-EXT/GEN delegate tables and the schedule helpers, against the
reference on the same numpy inputs.

The reference runs its lax path (``use_pallas=False``); tests/test_kernels
shows that path equals its Pallas path, and b=1 GMM is also checked against
the Pallas path here.  Picks, schedules and delegate tables must be equal;
radii and trajectories agree to rtol 1e-5 (fp32 dot products are summed in
another order by XLA and by torch).
"""
import importlib

import numpy as np
import pytest
import torch

# the packages re-export the function ``gmm`` over the module's name
rgmm = importlib.import_module("repro.core.gmm")
gmm = importlib.import_module("repro_torch.core.gmm")

RTOL = 1e-5


def _pts(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cpu(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "sqeuclidean",
                                    "manhattan"])
def test_gmm_b1_matches_reference(metric):
    pts = _pts(301, 7, 5)
    want = rgmm.gmm(pts, 10, metric=metric)
    got = gmm.gmm(_cpu(pts), 10, metric=metric)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_allclose(float(got.radius), float(want.radius),
                               rtol=RTOL)
    np.testing.assert_allclose(got.sel_dist.numpy(), np.asarray(want.sel_dist),
                               rtol=RTOL)
    # at the selected centers the field is sqrt/arccos of a rounding residue
    # of the factorized form (exactly 0 in exact arithmetic): compare the
    # other rows
    off = np.ones(301, bool)
    off[np.asarray(want.idx)] = False
    np.testing.assert_allclose(got.min_dist.numpy()[off],
                               np.asarray(want.min_dist)[off],
                               rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_gmm_b1_matches_reference_pallas_path(metric):
    pts = _pts(301, 7, 6)
    want = rgmm.gmm(pts, 10, metric=metric, use_pallas=True)
    got = gmm.gmm(_cpu(pts), 10, metric=metric, use_pallas=False)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(float(got.radius), float(want.radius),
                               rtol=1e-4)


def test_gmm_mask_and_start():
    pts = _pts(200, 3, 7)
    mask = np.random.default_rng(1).uniform(size=200) > 0.3
    mask[4] = True
    want = rgmm.gmm(pts, 12, mask=mask, start=4)
    got = gmm.gmm(_cpu(pts), 12, mask=mask, start=4)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert mask[got.idx.numpy()[1:]].all()


@pytest.mark.parametrize("schedule,k", [(((8, 4), (1, 6)), 38),
                                        (((4, 3), (2, 2), (1, 3)), 19),
                                        (((1, 9),), 9), (((8, 2),), 16)])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_gmm_schedule_matches_reference(schedule, k, metric):
    pts = _pts(2000, 4, k)
    want = rgmm.gmm_schedule(pts, k, schedule, metric=metric)
    got = gmm.gmm_schedule(_cpu(pts), k, schedule, metric=metric)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.counts == want.counts and got.schedule == want.schedule
    np.testing.assert_allclose(got.traj.numpy(), np.asarray(want.traj),
                               rtol=RTOL)
    np.testing.assert_allclose(got.margins.numpy(), np.asarray(want.margins),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.radius), float(want.radius),
                               rtol=RTOL)


def test_gmm_schedule_b1_equals_gmm():
    # the schedule engine at b=1 is exact sequential GMM, bit for bit
    pts = _cpu(_pts(500, 5, 2))
    a = gmm.gmm(pts, 20)
    b = gmm.gmm_schedule(pts, 20, ((1, 20),))
    assert torch.equal(a.idx, b.idx)
    assert torch.equal(a.radius, b.radius)


def test_gmm_batched_matches_reference():
    pts = _pts(3000, 6, 11)
    want = rgmm.gmm_batched(pts, 24, b=8, chunk=1000)
    got = gmm.gmm_batched(_cpu(pts), 24, b=8, chunk=1000)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=RTOL)
    with pytest.raises(ValueError):
        gmm.gmm_batched(_cpu(pts), 20, b=8)


@pytest.mark.parametrize("b", [1, 4])
def test_gmm_ext_and_gen_match_reference(b):
    pts = _pts(600, 3, 12)
    want = rgmm.gmm_ext(pts, 5, 16, b=b)
    got = gmm.gmm_ext(_cpu(pts), 5, 16, b=b)
    for f in ("kernel_idx", "delegate_idx", "delegate_valid", "multiplicity",
              "assign"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    gw = rgmm.gmm_gen(pts, 5, 16, b=b)
    gg = gmm.gmm_gen(_cpu(pts), 5, 16, b=b)
    np.testing.assert_array_equal(gg.multiplicity.numpy(),
                                  np.asarray(gw.multiplicity))
    np.testing.assert_allclose(gg.points.numpy(), np.asarray(gw.points))


def test_gmm_ext_from_kernel_matches_reference():
    pts = _pts(500, 4, 13)
    idx = np.arange(0, 500, 25)
    want = rgmm.gmm_ext_from_kernel(pts, idx, 1.0, 4, metric="cosine",
                                    chunk=128)
    got = gmm.gmm_ext_from_kernel(_cpu(pts), torch.as_tensor(idx), 1.0, 4,
                                  metric="cosine", chunk=128)
    np.testing.assert_array_equal(got.delegate_idx.numpy(),
                                  np.asarray(want.delegate_idx))
    np.testing.assert_array_equal(got.delegate_valid.numpy(),
                                  np.asarray(want.delegate_valid))


def test_schedule_helpers_match_reference():
    for sched in (((8, 4), (1, 6)), ((1, 5),), ((4, 2), (2, 3), (1, 1))):
        assert gmm.schedule_sweep_counts(sched) == \
            rgmm.schedule_sweep_counts(sched)
        assert gmm.schedule_fold_sizes(sched) == \
            rgmm.schedule_fold_sizes(sched)
    assert gmm.validate_schedule([(8, 2), (1, 3)], 19) == ((8, 2), (1, 3))
    with pytest.raises(ValueError):
        gmm.validate_schedule(((8, 2),), 17)
    with pytest.raises(ValueError):
        gmm.validate_schedule(((0, 2),), 0)
    for k, b in ((24, 8), (20, 8), (7, 3), (5, 1)):
        assert gmm.effective_block(k, b) == rgmm.effective_block(k, b)


def test_pad_for_engine_and_labels():
    pts = torch.ones((10, 2))
    mask = torch.tensor([True] * 7 + [False] * 3)
    lab = gmm.mask_to_labels(mask)
    np.testing.assert_array_equal(
        lab.numpy(), np.asarray(rgmm.mask_to_labels(mask.numpy())))
    pp, pl, ch = gmm.pad_for_engine(pts, lab, 4)
    rp, rl, rch = rgmm.pad_for_engine(pts.numpy(), lab.numpy(), 4)
    assert ch == rch and pp.shape == tuple(rp.shape)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))


def test_grouped_sweep_is_a_later_slice():
    """The grouped (m > 1) sweep came with the constrained slice: each row
    folds only its own group's centers, and a row labelled -1 keeps its
    running min and is never a candidate."""
    pts = torch.as_tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 3.0], [5.0, 5.0]])
    prep = gmm._sweep_points(pts, "euclidean")
    labels = torch.tensor([0, 1, 0, -1], dtype=torch.int32)
    sweep = gmm._make_grouped_sweep(prep, labels, 2, 1, 0, "euclidean",
                                    False)
    md, cd, ci = sweep(torch.full((4,), float("inf")),
                       torch.tensor([[0], [1]]))
    np.testing.assert_allclose(md[:3].numpy(), [0.0, 0.0, 3.0], atol=1e-6)
    assert float(md[3]) == float("inf")
    np.testing.assert_allclose(cd[:, 0].numpy(), [3.0, 0.0], atol=1e-6)
    assert ci[:, 0].tolist() == [2, 1]
