"""Port parity for AFZ, the paper's Table 4 competitor
(``repro_torch.core.afz``): the local-search core-set of one shard and the
2-round MR harness against the reference's on the same numpy inputs.

The port's shard distance matrix is the B3 kernel's plain version on the
CPU (float64 sums rounded once) where the reference's is XLA's fp32 product;
the local search compares sums of those entries against a relative bar
of 1e-7.  The fixtures are normal data, whose swap gains sit far from that
bar, so the same subset and the same value (rtol 1e-4) are required.
"""
import importlib

import numpy as np
import pytest
import torch

rafz = importlib.import_module("repro.core.afz")
pafz = importlib.import_module("repro_torch.core.afz")

RTOL = 1e-4


def _pts(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
@pytest.mark.parametrize("seed", [0, 3])
def test_afz_coreset_clique_equals_reference(metric, seed):
    pts = _pts(300, 5, seed)
    want = rafz.afz_coreset_clique(pts, 12, metric=metric, seed=seed)
    got = pafz.afz_coreset_clique(torch.as_tensor(pts), 12, metric=metric,
                                  seed=seed, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_afz_coreset_small_shard_is_returned_whole():
    pts = _pts(10, 3, 1)
    got = pafz.afz_coreset_clique(pts, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), pts)


@pytest.mark.parametrize("ell", [2, 4])
def test_afz_mr_clique_equals_reference(ell):
    pts = _pts(1001, 6, 5)
    w_sol, w_val = rafz.afz_mr_clique(pts, 6, 16, num_reducers=ell, seed=2)
    g_sol, g_val = pafz.afz_mr_clique(pts, 6, 16, num_reducers=ell, seed=2,
                                      device="cpu")
    np.testing.assert_array_equal(g_sol.numpy(), np.asarray(w_sol))
    np.testing.assert_allclose(g_val, w_val, rtol=RTOL)
