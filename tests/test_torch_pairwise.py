"""Port parity for the distance-tile kernel (B3): the port's
``kernels.ops.pairwise`` on CPU tensors (its plain version,
``kernels.ref.pairwise_ref``) against the reference's ``ops.pairwise`` (the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
against the reference's oracle ``ref.pairwise_ref``, on the same numpy
inputs.

Tolerance: rtol = atol = 3e-5, the reference's own kernel parity — XLA
sums the dot products in fp32, the port in float64 rounded once.  Two
places get a stated wider bound because the transform amplifies a 1-ulp
difference of the dot product: ``arccos`` near |sim| = 1 (slope
1/sqrt(1 - sim²)) and ``sqrt`` near 0 (slope 1/(2 sqrt(d²))).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

MODES = ["sqeuclidean", "euclidean", "dot", "cosine"]
TOL = dict(rtol=3e-5, atol=3e-5)
# ragged on purpose: none of m, n, d is a multiple of a tile edge
SHAPES = [(64, 3, 32), (100, 17, 50), (257, 64, 129), (33, 5, 1),
          (1, 7, 1), (300, 130, 65)]


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(m, d, n, seed):
    rg = np.random.default_rng(seed)
    return (rg.normal(size=(m, d)).astype(np.float32),
            rg.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_pairwise_matches_reference_kernel_and_oracle(shape, mode):
    m, d, n = shape
    x, y = _inputs(m, d, n, m * d + n)
    got = ops.pairwise(torch.as_tensor(x), torch.as_tensor(y), mode).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    want_kernel = np.asarray(rops.pairwise(jnp.asarray(x), jnp.asarray(y),
                                           mode))
    xr, yr = (_norm(x), _norm(y)) if mode == "cosine" else (x, y)
    want_oracle = np.asarray(rref.pairwise_ref(jnp.asarray(xr),
                                               jnp.asarray(yr), mode))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_prepared_inputs_and_passed_norms(mode):
    # the streaming core-set prepares rows once and passes the norms in:
    # the result is the unprepared call's
    x, y = _inputs(90, 11, 40, 7)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    px, py = ops.prepare(tx, mode), ops.prepare(ty, mode)
    got = ops.pairwise(px.points, py.points, mode, xsq=px.xsq, ysq=py.xsq,
                       prepared=True)
    torch.testing.assert_close(got, ops.pairwise(tx, ty, mode), rtol=0,
                               atol=0)


def test_cosine_near_parallel_rows_wider_bound():
    # sim within a few ulps of 1: arccos'(sim) = -1/sqrt(1 - sim²) turns a
    # 1-ulp (6e-8) dot difference into up to ~3.5e-4 of angle; the bound
    # is that slope times 4 ulps
    rg = np.random.default_rng(3)
    y = rg.normal(size=(20, 16)).astype(np.float32)
    x = (y + rg.normal(size=y.shape).astype(np.float32) * 1e-4)
    got = ops.pairwise(torch.as_tensor(x), torch.as_tensor(y),
                       "cosine").numpy()
    want = np.asarray(rops.pairwise(jnp.asarray(x), jnp.asarray(y),
                                    "cosine"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.4e-3)
    # far from the diagonal the tight bound still holds
    off = ~np.eye(20, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], **TOL)


def test_euclidean_near_zero_wider_bound():
    # d² near 0: the factorized form cancels ||x||² + ||y||² - 2x·y to a few
    # ulps of ||x||² (~1e-6 here), and sqrt turns that into ~1e-3; the
    # diagonal of a self-distance matrix is such a place (not zeroed, as in
    # the reference)
    x = np.random.default_rng(4).normal(size=(50, 8)).astype(np.float32)
    got = ops.pairwise(torch.as_tensor(x), torch.as_tensor(x),
                       "euclidean").numpy()
    want = np.asarray(rops.pairwise(jnp.asarray(x), jnp.asarray(x),
                                    "euclidean"))
    assert np.abs(np.diag(got)).max() < 4e-3      # rounding size, not 0
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
    off = ~np.eye(50, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(4096, 64, 257), (250, 3, 33),
                                   (1000, 17, 129)])
def test_one_column_call_equals_tile_column_bit_for_bit(mode, shape):
    # the far-point path of the streaming core-set recomputes one column
    # after each insert: in the plain version every entry is a float64 sum
    # rounded once, which depends on its two rows only, as in the kernel
    m, d, n = shape
    x, y = _inputs(m, d, n, 11)
    px = ops.prepare(torch.as_tensor(x), mode)
    py = ops.prepare(torch.as_tensor(y), mode)
    full = ops.pairwise(px.points, py.points, mode, xsq=px.xsq, ysq=py.xsq,
                        prepared=True)
    for s in (0, 1, n // 2, n - 1):
        ysq = None if py.xsq is None else py.xsq[s:s + 1]
        col = ops.pairwise(px.points, py.points[s:s + 1], mode, xsq=px.xsq,
                           ysq=ysq, prepared=True)
        assert torch.equal(col[:, 0], full[:, s]), (mode, shape, s)
    # rows are independent too: a tail of the rows gives the same entries
    tail = ops.pairwise(px.points[5:], py.points, mode,
                        xsq=None if px.xsq is None else px.xsq[5:],
                        ysq=py.xsq, prepared=True)
    assert torch.equal(tail, full[5:])


def test_plain_version_order_matches_sweep_distances():
    # the float64 plain product and the fp32 BLAS product behind the sweeps
    # agree to the kernel tolerance (they differ only in rounding)
    x, y = _inputs(300, 40, 70, 5)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for mode in MODES:
        torch.testing.assert_close(ref.pairwise_ref(tx, ty, mode),
                                   ref.sweep_dist_ref(tx, ty, mode), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_is_grouped_sweeps_product(mode):
    # B3 and B4 share one plain arithmetic: the same rows give the same
    # distances through pairwise_ref and grouped_dist_ref, bit for bit
    x, y = _inputs(513, 77, 40, 13)
    px = ops.prepare(torch.as_tensor(x), mode)
    py = ops.prepare(torch.as_tensor(y), mode)
    got = ref.pairwise_ref(px.points, py.points, mode, xsq=px.xsq)
    want = ref.grouped_dist_ref(px.points, py.points, mode, xsq=px.xsq)
    assert torch.equal(got, want)


def test_plain_dot_is_float64_product_rounded_once():
    # every dot product is the float64 sum of exact fp32 products, rounded
    # once to float32 (numpy's float64 product rounds to the same float32:
    # no sum of these inputs lies within float64 rounding of an fp32
    # rounding boundary)
    x, y = _inputs(300, 500, 90, 17)
    got = ref.pairwise_ref(torch.as_tensor(x), torch.as_tensor(y),
                           "dot").numpy()
    want = -(x.astype(np.float64) @ y.astype(np.float64).T).astype(
        np.float32)
    np.testing.assert_array_equal(got, want)
    # and it is not the fp32 product: the two part in the last bits
    fp32 = -(torch.as_tensor(x) @ torch.as_tensor(y).T).numpy()
    assert (got != fp32).any()


def test_cuda_wrapper_rejects_cpu_tensors():
    from repro_torch.kernels.pairwise import pairwise_cuda
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="contiguous float32"):
        pairwise_cuda(x, x[:2], mode="dot")
    with pytest.raises(ValueError, match="squared norms"):
        pairwise_cuda(x, x[:2], mode="euclidean")
    with pytest.raises(ValueError, match=r"\(m, d\) and \(n, d\)"):
        pairwise_cuda(x, torch.zeros((2, 3)), mode="dot")
