"""Port parity for the sweep kernels: the port's wrappers on CPU tensors
(their plain torch versions) against the reference's Pallas kernels run in
interpret mode, plus the torch emulation of the CUDA kernel's tiling.

Tolerance: rtol = atol = 3e-5, the reference's own kernel parity
(tests/test_kernels.py) — fp32 dot products are summed in another order by
XLA and by torch.  Index sets are compared through the values they select,
so exact ties pass; where ties are the point (duplicate rows, masked rows,
the n-1 clamp), indices are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gmm_topb import tile_rows

SHAPES = [(64, 3), (100, 17), (257, 64), (512, 128), (33, 5)]
MODES = ["sqeuclidean", "euclidean", "dot", "cosine"]
TOL = dict(rtol=3e-5, atol=3e-5)


def _case(n, d, b, seed):
    rg = np.random.default_rng(seed)
    pts = rg.normal(size=(n, d)).astype(np.float32)
    cs = rg.normal(size=(b, d)).astype(np.float32)
    mi = rg.uniform(0.3, 4.0, size=(n,)).astype(np.float32)
    mask = rg.uniform(size=n) > 0.15
    return pts, cs, mi, mask


def _port(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _ref(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 4, 32])
def test_gmm_topb_matches_pallas(shape, mode, p):
    n, d = shape
    pts, cs, mi, mask = _case(n, d, 3, n * d + p)
    r_min, r_val, r_idx = rops.gmm_topb(*_ref(pts, cs, mi, mask), mode, p=p)
    g_min, g_val, g_idx = ops.gmm_topb(*_port(pts, cs, mi, mask), mode, p=p)
    np.testing.assert_allclose(g_min.numpy(), np.asarray(r_min), **TOL)
    np.testing.assert_allclose(g_val.numpy(), np.asarray(r_val), **TOL)
    field = np.where(mask, np.asarray(r_min), -np.inf)
    np.testing.assert_allclose(np.sort(field[g_idx.numpy()]),
                               np.sort(field[np.asarray(r_idx)]), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_gmm_update_select_matches_pallas(shape, mode):
    n, d = shape
    pts, cs, mi, mask = _case(n, d, 3, n + d)
    r_min, r_arg, r_max = rops.gmm_update_select(*_ref(pts, cs, mi, mask),
                                                 mode)
    g_min, g_arg, g_max = ops.gmm_update_select(*_port(pts, cs, mi, mask),
                                                mode)
    np.testing.assert_allclose(g_min.numpy(), np.asarray(r_min), **TOL)
    np.testing.assert_allclose(float(g_max), float(r_max), **TOL)
    field = np.where(mask, np.asarray(r_min), -np.inf)
    assert field[int(g_arg)] == pytest.approx(field[int(r_arg)], rel=3e-5)


def test_duplicate_rows_tie_to_lower_index():
    # every row appears three times: equal field values must be ordered by
    # index, exactly as lax.top_k orders them
    rg = np.random.default_rng(3)
    base = rg.normal(size=(20, 4)).astype(np.float32)
    pts = np.concatenate([base, base, base])
    cs = rg.normal(size=(2, 4)).astype(np.float32)
    mi = np.full((60,), np.inf, np.float32)
    mask = np.ones(60, bool)
    _, r_val, r_idx = rops.gmm_topb(*_ref(pts, cs, mi, mask), "euclidean",
                                    p=12)
    _, g_val, g_idx = ops.gmm_topb(*_port(pts, cs, mi, mask), "euclidean",
                                   p=12)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(r_idx))
    _, r_arg, _ = rops.gmm_update_select(*_ref(pts, cs, mi, mask),
                                         "euclidean")
    _, g_arg, _ = ops.gmm_update_select(*_port(pts, cs, mi, mask),
                                        "euclidean")
    assert int(g_arg) == int(r_arg)


def test_masked_rows_never_selected_and_clamp():
    # 3 selectable rows of 5, p = 8 > n: the pool's tail is -inf, drawn from
    # the masked rows and then from the pad rows of the tile, whose indices
    # are clamped to n - 1 — the reference wrapper's contract
    rg = np.random.default_rng(4)
    n = 5
    pts = rg.normal(size=(n, 4)).astype(np.float32)
    cs = rg.normal(size=(2, 4)).astype(np.float32)
    mi = np.full((n,), np.inf, np.float32)
    mask = np.array([True, False, True, True, False])
    _, r_val, r_idx = rops.gmm_topb(*_ref(pts, cs, mi, mask), "sqeuclidean",
                                    p=8)
    args = _port(pts, cs, mi, mask)
    _, g_val, g_idx = ops.gmm_topb(*args, "sqeuclidean", p=8)
    prep = ops.prepare(args[0], "sqeuclidean")
    _, t_val, t_idx = ref.gmm_topb_tiled_ref(prep.points, args[1], args[2],
                                             args[3], "sqeuclidean", p=8,
                                             bn=8, xsq=prep.xsq)
    for val, idx in ((g_val, g_idx), (t_val, t_idx)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_allclose(val.numpy(), np.asarray(r_val), **TOL)
    assert set(g_idx.numpy()[:3]) == {0, 2, 3}
    assert (g_idx.numpy()[5:] == n - 1).all()
    assert np.isneginf(g_val.numpy()[3:]).all()


@pytest.mark.parametrize("n,bn,p", [(1000, 256, 32), (1025, 256, 64),
                                    (300, 512, 128), (77, 256, 1),
                                    (4097, 1024, 256)])
@pytest.mark.parametrize("mode", MODES)
def test_tiled_emulation_equals_whole_array(n, bn, p, mode):
    # the CUDA kernel's split (tile-local top-p) and the wrapper's stable
    # merge give the whole-array top-p, indices included
    pts, cs, mi, mask = _case(n, 8, 4, n + bn + p)
    pts[5] = pts[9]            # an exact tie across the field
    x, c, m, k = _port(pts, cs, mi, mask)
    prep = ops.prepare(x, mode)
    cc = ops._normalize(c) if mode == "cosine" else c
    w_min, w_val, w_idx = ref.gmm_topb_ref(prep.points, cc, m, k, mode, p,
                                           xsq=prep.xsq)
    t_min, t_val, t_idx = ref.gmm_topb_tiled_ref(prep.points, cc, m, k,
                                                 mode, p, bn=bn,
                                                 xsq=prep.xsq)
    assert torch.equal(w_min, t_min)
    assert torch.equal(w_val, t_val)
    assert torch.equal(w_idx, t_idx)


def test_tile_rows_keeps_bn_at_least_p():
    for p in (1, 2, 31, 32, 64, 100, 128, 256, 1000, 4096):
        bn = tile_rows(p)
        assert bn >= p and bn in (256, 512, 1024, 2048, 4096)
    with pytest.raises(ValueError):
        tile_rows(4097)


def test_cpu_wrappers_launch_nothing():
    ops.reset_launches()
    pts, cs, mi, mask = _case(64, 3, 2, 0)
    ops.gmm_topb(*_port(pts, cs, mi, mask), "cosine", p=4)
    ops.gmm_update_select(*_port(pts, cs, mi, mask), "euclidean")
    ops.pairwise(*_port(pts, cs), "euclidean")
    assert ops.LAUNCHES == {"gmm_topb": 0, "gmm_update_select": 0,
                            "pairwise": 0}


def test_manhattan_has_no_kernel_mode():
    pts, cs, mi, mask = _case(16, 3, 1, 0)
    with pytest.raises(ValueError, match="no kernel path"):
        ops.gmm_topb(*_port(pts, cs, mi, mask), "manhattan", p=2)

