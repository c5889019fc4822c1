"""Port parity for the grouped sweep (B4): the port's wrapper on CPU tensors
(its plain torch version) against the reference's Pallas kernel run in
interpret mode, plus the torch emulation of the CUDA kernel's tiling.

Tolerance: rtol = atol = 3e-5, the reference's own kernel parity
(tests/test_kernels.py) — fp32 dot products are summed in another order by
XLA and by torch.  Index sets are compared through the values they select,
so exact ties pass.  ``min_out`` is compared on labelled rows only: a row
labelled -1 keeps its ``min_in`` in the port (the reference's Pallas
semantics), while the reference's plain path folds group 0 into it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gmm_update import grouped_tile_rows

MODES = ["sqeuclidean", "euclidean", "dot", "cosine"]
SHAPES = [(100, 5, 1), (257, 17, 2), (1030, 9, 5)]   # (n, d, m), n ragged
TOL = dict(rtol=3e-5, atol=3e-5)


def _case(n, d, m, bc, seed):
    """Points, per-group centers, min_in straddling the field, labels with
    group 1 empty (m > 2) and about a tenth of the rows labelled -1."""
    rg = np.random.default_rng(seed)
    pts = rg.normal(size=(n, d)).astype(np.float32)
    cen = rg.normal(size=(m, bc, d)).astype(np.float32)
    mi = rg.uniform(0.3, 4.0, size=(n,)).astype(np.float32)
    lab = rg.integers(0, m, size=n).astype(np.int32)
    if m > 2:
        lab[lab == 1] = 0
    lab[rg.uniform(size=n) < 0.1] = -1
    return pts, cen, mi, lab


def _both(pts, cen, mi, lab, mode, p):
    r = rops.grouped_gmm_topb(jnp.asarray(pts), jnp.asarray(cen),
                              jnp.asarray(mi), jnp.asarray(lab), mode, b=p)
    g = ops.grouped_gmm_topb(*(torch.as_tensor(a)
                               for a in (pts, cen, mi, lab)), mode, p)
    return [np.asarray(a) for a in r], [a.numpy() for a in g]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3, 8])
def test_grouped_gmm_topb_matches_pallas(shape, mode, p):
    n, d, m = shape
    pts, cen, mi, lab = _case(n, d, m, 3, n + d + p)
    (r_min, r_val, r_idx), (g_min, g_val, g_idx) = _both(pts, cen, mi, lab,
                                                         mode, p)
    mine = lab >= 0
    np.testing.assert_allclose(g_min[mine], r_min[mine], **TOL)
    np.testing.assert_array_equal(g_min[~mine], mi[~mine])
    np.testing.assert_allclose(g_val, r_val, **TOL)
    assert g_idx.shape == (m, p) and g_idx.min() >= 0 and g_idx.max() < n
    for gi in range(m):
        own = np.where(lab == gi, r_min, -np.inf)
        np.testing.assert_allclose(np.sort(own[g_idx[gi]]),
                                   np.sort(own[r_idx[gi]]), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_empty_group_and_unlabelled_rows_are_never_candidates(mode):
    pts, cen, mi, lab = _case(300, 6, 4, 2, 7)
    _, (g_min, g_val, g_idx) = _both(pts, cen, mi, lab, mode, 5)
    assert np.all(np.isneginf(g_val[1]))
    for gi in (0, 2, 3):
        fin = np.isfinite(g_val[gi])
        assert np.all(lab[g_idx[gi][fin]] == gi)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bn,p", [(16, 1), (64, 8), (256, 3), (1024, 8)])
def test_tiled_emulation_equals_plain(mode, bn, p):
    """The kernel's tiling (per-tile, per-group top-p with -inf fills at
    the tile's first row, then the per-group merge) gives the plain
    version's values, and the same indices for every finite entry."""
    pts, cen, mi, lab = _case(777, 12, 5, 4, bn + p)
    x, c, m_in, lb = (torch.as_tensor(a) for a in (pts, cen, mi, lab))
    prep = ops.prepare(x, mode)
    c = ops._normalize(c) if mode == "cosine" else c
    want = ref.gmm_grouped_topb_ref(prep.points, c, m_in, lb, mode, p,
                                    xsq=prep.xsq)
    got = ref.gmm_grouped_topb_tiled_ref(prep.points, c, m_in, lb, mode, p,
                                         bn=bn, xsq=prep.xsq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fin = torch.isfinite(want[1])
    assert torch.equal(got[2][fin], want[2][fin])
    assert int(got[2].min()) >= 0 and int(got[2].max()) < 777


def test_p_beyond_n_fills_like_the_reference():
    pts, cen, mi, lab = _case(6, 3, 2, 2, 1)
    (r_min, r_val, r_idx), (g_min, g_val, g_idx) = _both(pts, cen, mi, lab,
                                                         "euclidean", 9)
    np.testing.assert_allclose(g_val, r_val, **TOL)
    assert g_idx.max() <= 5 and g_idx.shape == (2, 9)


def test_cpu_wrapper_launches_nothing_and_tile_rows():
    ops.reset_launches()
    pts, cen, mi, lab = _case(64, 3, 2, 2, 0)
    ops.grouped_gmm_topb(*(torch.as_tensor(a) for a in (pts, cen, mi, lab)),
                         "cosine", 4)
    assert ops.LAUNCHES["gmm_grouped_topb"] == 0
    assert [grouped_tile_rows(p) for p in (1, 128, 256, 512, 1024)] == \
        [1024, 1024, 1024, 2048, 4096]
