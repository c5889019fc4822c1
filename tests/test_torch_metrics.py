"""Port parity for ``core.metrics``: the port's torch metrics against the
reference's jnp metrics on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 — both keep the factorized euclidean form and
the 1e-30 cosine floor, so only the fp32 summation order of the dot
products differs between XLA and torch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import metrics as rmetrics
from repro_torch.core import metrics

METRICS = ["euclidean", "sqeuclidean", "cosine", "manhattan"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(7, 3), (40, 17), (65, 64)])
def test_pairwise_and_point_to_set_match(metric, shape):
    m, d = shape
    rg = np.random.default_rng(m * d)
    x = rg.normal(size=(m, d)).astype(np.float32)
    y = rg.normal(size=(m // 2 + 1, d)).astype(np.float32)
    want = np.asarray(rmetrics.get_metric(metric).pairwise(jnp.asarray(x),
                                                           jnp.asarray(y)))
    got = metrics.get_metric(metric).pairwise(torch.as_tensor(x),
                                              torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(rmetrics.get_metric(metric).point_to_set(
        jnp.asarray(x), jnp.asarray(y[0])))
    got = metrics.get_metric(metric).point_to_set(
        torch.as_tensor(x), torch.as_tensor(y[0])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_rows_keep_the_normalization_floor():
    # an all-zero row normalizes to zero (the 1e-30 floor): arccos(0)
    x = np.zeros((2, 4), np.float32)
    x[1, 0] = 1.0
    want = np.asarray(rmetrics.get_metric("cosine").pairwise(
        jnp.asarray(x), jnp.asarray(x)))
    got = metrics.get_metric("cosine").pairwise(torch.as_tensor(x),
                                                torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_registry_matches_reference():
    for name in METRICS:
        assert (metrics.get_metric(name).is_metric
                == rmetrics.get_metric(name).is_metric)
    with pytest.raises(KeyError):
        metrics.get_metric("hamming")
    m = metrics.get_metric("euclidean")
    assert metrics.get_metric(m) is m
