"""Tests that need a CUDA card: the hand-written kernels against their plain
torch versions, and the engine (batch and streaming) with the kernels
against the engine without them.  They skip without a card (the CUDA
kernels have no CPU mode) and import nothing of JAX, so they run where only
PyTorch for CUDA is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerance: rtol = atol = 3e-5 for the sweep kernels B1/B2 (the
reference's kernel parity); the engine runs must agree exactly on picks and
schedules and to rtol 1e-4 on radii and values (the reference's end-to-end
parity).  The distance tile (B3) and the grouped sweep (B4) share one
arithmetic with their plain versions — every dot product accumulated in
float64 from exact fp32 products and rounded once, the epilogue one rounded
fp32 operation at a time — so kernel and plain are held equal bit for bit
but for near-ties: two float64 orders round apart only where the exact sum
lies within float64 rounding of an fp32 rounding boundary, and there the
test proves it (the two dot products one ulp apart, the exact sum at the
midpoint between them within the float64 error bound, the epilogue the same
on both sides) and reports the tie as a warning.  A stream's decisions must
be equal on both paths; its d_i (and the phase log's) agree
to rtol 1e-5, which only absorbs a last-ulp difference of sqrt/acos between
the kernel's and torch's math library.
"""
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core
from repro_torch.kernels import ops, ref

MODES = ["sqeuclidean", "euclidean", "dot", "cosine"]
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _equal_but_ties(got, want, x, y, xsq, ysq, mode):
    """B3 kernel (got) against its plain version (want) on the prepared rows
    x, y: equal bit for bit except at near-ties.  At an entry that differs,
    the kernel's and the plain dot products must be adjacent fp32 values,
    the exact sum of the exact fp32 products must lie within the float64
    summation error bound (d·2^-52·Σ|x_k y_k|) of the midpoint between them,
    and the plain epilogue on each dot product must give that side's entry.
    The ties found are reported as a warning."""
    from repro_torch.kernels.pairwise import pairwise_cuda
    diff = (got != want).nonzero().tolist()
    if not diff:
        return
    assert len(diff) <= 8, f"{len(diff)} entries differ: more than ties"
    kdot = -pairwise_cuda(x, y, mode="dot")
    pdot = ref.dot64(x, y)
    xh, yh = x.double().cpu().numpy(), y.double().cpu().numpy()
    ties = []
    for i, j in diff:
        a, b = np.float32(kdot[i, j].item()), np.float32(pdot[i, j].item())
        assert np.nextafter(a, b) == b, (i, j, a, b)
        for dot, side in ((kdot, got), (pdot, want)):
            entry = ref._transform(
                dot[i:i + 1, j:j + 1],
                None if xsq is None else xsq[i:i + 1],
                None if ysq is None else ysq[j:j + 1], mode)
            assert torch.equal(entry[0, 0], side[i, j]), (i, j, mode)
        prods = [Fraction(u) * Fraction(v) for u, v in zip(xh[i], yh[j])]
        off = sum(prods) - (Fraction(float(a)) + Fraction(float(b))) / 2
        bound = (Fraction(len(prods)) * Fraction(1, 2 ** 52)
                 * sum(abs(q) for q in prods))
        assert abs(off) <= bound, (i, j, float(off), float(bound))
        ties.append(f"[{i},{j}] kernel {a!r} plain {b!r} (1 ulp), exact "
                    f"sum {float(off):.3g} from their midpoint (bound "
                    f"{float(bound):.3g})")
    warnings.warn(f"B3 near-ties, {mode}: " + "; ".join(ties))


def _case(n, d, b, seed, device):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn((n, d), generator=g)
    cs = torch.randn((b, d), generator=g)
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    mask = torch.rand((n,), generator=g) > 0.15
    return [t.to(device) for t in (pts, cs, mi, mask)]


@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernels_match_plain_on_card(cuda_device, mode):
    for (n, d), b, p in [((4097, 128), 8, 32), ((1000, 17), 3, 1),
                         ((33, 5), 1, 4), ((3000, 64), 12, 256)]:
        x, c, m, k = _case(n, d, b, n + d, cuda_device)
        ops.reset_launches()
        g_min, g_val, g_idx = ops.gmm_topb(x, c, m, k, mode, p=p)
        u_min, u_arg, u_max = ops.gmm_update_select(x, c, m, k, mode)
        assert ops.LAUNCHES == {"gmm_topb": 1, "gmm_update_select": 1,
                                "pairwise": 0, "gmm_grouped_topb": 0}
        prep = ops.prepare(x, mode)
        cc = ops._normalize(c) if mode == "cosine" else c
        r_min, r_val, r_idx = ref.gmm_topb_ref(prep.points, cc, m, k, mode,
                                               p, xsq=prep.xsq)
        torch.testing.assert_close(g_min, r_min, **TOL)
        torch.testing.assert_close(g_val, r_val, **TOL)
        field = torch.where(k, r_min, torch.full_like(r_min, -float("inf")))
        torch.testing.assert_close(torch.sort(field[g_idx]).values,
                                   torch.sort(field[r_idx]).values, **TOL)
        torch.testing.assert_close(u_min, r_min, **TOL)
        torch.testing.assert_close(u_max, field.max(), **TOL)
        torch.testing.assert_close(ref.take(field, u_arg), field.max(),
                                   **TOL)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("knobs", [{}, {"kprime": 48, "b": 1},
                                   {"kprime": 64, "b": 8, "chunk": 0}])
def test_cuda_engine_with_and_without_kernels(cuda_device, metric, knobs):
    pts = np.random.default_rng(5).normal(size=(6000, 24)).astype(np.float32)
    x = torch.as_tensor(pts, device=cuda_device)
    runs = {}
    for use_pallas in ("auto", False):
        ops.reset_launches()
        runs[use_pallas] = repro_torch.diversify(
            x, k=8, metric=metric, execution=repro_torch.ExecutionSpec(
                use_pallas=use_pallas, **knobs))
        launched = sum(ops.LAUNCHES.values())
        assert (launched > 0) == (use_pallas == "auto")
    kern, plain = runs["auto"], runs[False]
    np.testing.assert_array_equal(kern.indices, plain.indices)
    np.testing.assert_allclose(kern.value, plain.value, rtol=1e-4)
    np.testing.assert_allclose(float(kern.coreset.radius),
                               float(plain.coreset.radius), rtol=1e-4)
    if plain.cert is not None:
        assert kern.cert.b_schedule == plain.cert.b_schedule
        assert kern.cert.meets_target == plain.cert.meets_target
        np.testing.assert_allclose(kern.cert.radii, plain.cert.radii,
                                   rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_pairwise_matches_plain_on_card(cuda_device, mode):
    # ragged m, n, d; the three tile configurations (narrow n <= 8, medium,
    # wide) all run, and every entry is the same sequence of float64 steps
    # in each
    g = torch.Generator().manual_seed(3)
    for m, n, d in [(33, 5, 3), (1000, 17, 129), (4097, 300, 64),
                    (4097, 1025, 17), (70, 1, 5000)]:
        x = torch.randn((m, d), generator=g).to(cuda_device)
        y = torch.randn((n, d), generator=g).to(cuda_device)
        ops.reset_launches()
        got = ops.pairwise(x, y, mode)
        assert ops.LAUNCHES["pairwise"] == 1
        px, py = ops.prepare(x, mode), ops.prepare(y, mode)
        want = ref.pairwise_ref(px.points, py.points, mode, xsq=px.xsq,
                                ysq=py.xsq)
        _equal_but_ties(got, want, px.points, py.points, px.xsq, py.xsq,
                        mode)
        full = ops.pairwise(px.points, py.points, mode, xsq=px.xsq,
                            ysq=py.xsq, prepared=True)
        assert torch.equal(full, got)
        for s in sorted({0, n // 2, n - 1}):
            col = ops.pairwise(px.points, py.points[s:s + 1], mode,
                               xsq=px.xsq,
                               ysq=None if py.xsq is None
                               else py.xsq[s:s + 1], prepared=True)
            assert torch.equal(col[:, 0], full[:, s]), (m, n, d, s)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [1, 3, 4, 5, 17, 5000])
def test_cuda_pairwise_bit_for_bit_off_the_mma_tiles(cuda_device, mode, d):
    """B3 against its plain version, bit for bit but for near-ties, at m, n
    and d that are no multiple of any tile edge or tensor-core step: the
    narrow (n <= 8), medium (m = 301) and wide (m = 4,097, n = 1,025)
    configurations; a one-column call equals its tile's column and a tail
    of the rows the tile's rows."""
    g = torch.Generator().manual_seed(d)
    for m in (301, 4097):
        x = torch.randn((m, d), generator=g).to(cuda_device)
        px = ops.prepare(x, mode)
        for n in (1, 2, 4, 5, 1025):
            y = torch.randn((n, d), generator=g).to(cuda_device)
            py = ops.prepare(y, mode)
            got = ops.pairwise(px.points, py.points, mode, xsq=px.xsq,
                               ysq=py.xsq, prepared=True)
            want = ref.pairwise_ref(px.points, py.points, mode, xsq=px.xsq,
                                    ysq=py.xsq)
            _equal_but_ties(got, want, px.points, py.points, px.xsq, py.xsq,
                            mode)
            for s in sorted({0, n // 2, n - 1}):
                col = ops.pairwise(px.points, py.points[s:s + 1], mode,
                                   xsq=px.xsq,
                                   ysq=None if py.xsq is None
                                   else py.xsq[s:s + 1], prepared=True)
                assert torch.equal(col[:, 0], got[:, s]), (m, n, s)
            tail = ops.pairwise(px.points[7:], py.points, mode,
                                xsq=None if px.xsq is None else px.xsq[7:],
                                ysq=py.xsq, prepared=True)
            assert torch.equal(tail, got[7:]), (m, n)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_pairwise_self_distance_diagonal(cuda_device, mode):
    # a self-distance matrix: equal to the plain version and symmetric bit
    # for bit (x_i . x_j and x_j . x_i are the same products in the same
    # steps); the diagonal is not zeroed and holds rounding-size distances
    x = torch.randn((1000, 33), generator=torch.Generator().manual_seed(6))
    p = ops.prepare(x.to(cuda_device), mode)
    got = ops.pairwise(p.points, p.points, mode, xsq=p.xsq, ysq=p.xsq,
                       prepared=True)
    want = ref.pairwise_ref(p.points, p.points, mode, xsq=p.xsq, ysq=p.xsq)
    _equal_but_ties(got, want, p.points, p.points, p.xsq, p.xsq, mode)
    assert torch.equal(got, got.T)
    if mode != "dot":
        assert float(torch.diagonal(got).abs().max()) < 4e-3


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("smm_mode", ["plain", "ext", "gen"])
def test_cuda_stream_with_and_without_kernels(cuda_device, metric, smm_mode):
    rg = np.random.default_rng(9)
    n = 20000
    pts = (rg.normal(size=(n, 8)) * (1 + np.arange(n)[:, None] / 2000)) \
        .astype(np.float32)
    x = torch.as_tensor(pts, device=cuda_device)
    runs = {}
    for use_pallas in ("auto", False):
        smm = repro_torch.core.StreamingCoreset(
            6, 48, 8, metric=metric, mode=smm_mode, use_pallas=use_pallas)
        ops.reset_launches()
        for i in range(0, n, 1500):
            smm.update(x[i:i + 1500])
        launched = ops.LAUNCHES["pairwise"]
        assert (launched > 0) == (use_pallas == "auto")
        runs[use_pallas] = smm
    kern, plain = runs["auto"], runs[False]
    ks, ps = kern.state, plain.state
    assert torch.equal(ks.t_valid, ps.t_valid)
    assert torch.equal(ks.T[ks.t_valid], ps.T[ps.t_valid])
    assert torch.equal(ks.e_cnt, ps.e_cnt)
    np.testing.assert_allclose(float(ks.d_thr), float(ps.d_thr), rtol=1e-5)
    assert [c for c, _ in kern.phase_log] == [c for c, _ in plain.phase_log]
    np.testing.assert_allclose([d for _, d in kern.phase_log],
                               [d for _, d in plain.phase_log], rtol=1e-5)
    assert kern.generation == plain.generation
    kc, pc = kern.certificate(), plain.certificate()
    assert kc.counts == pc.counts
    np.testing.assert_allclose([kc.radius, kc.scale],
                               [pc.radius, pc.scale], rtol=1e-5)


def test_cuda_streaming_facade_runs_the_kernel_by_default(cuda_device):
    pts = np.random.default_rng(2).normal(size=(9000, 16)) \
        .astype(np.float32)
    ops.reset_launches()
    res = repro_torch.diversify(
        (pts[i:i + 1000] for i in range(0, 9000, 1000)), k=5,
        measure="remote-clique", metric="cosine")
    assert ops.LAUNCHES["pairwise"] > 0
    assert res.coreset.points.is_cuda
    assert res.solution.shape == (5, 16) and np.isfinite(res.value)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_cuda_batch_ext_assignment_runs_the_kernel(cuda_device, metric):
    # remote-clique's batch core-set recovers each point's nearest kernel
    # center through B3 tiles on the card (plain metric tiles without it)
    pts = np.random.default_rng(4).normal(size=(6000, 24)) \
        .astype(np.float32)
    x = torch.as_tensor(pts, device=cuda_device)
    runs = {}
    for use_pallas in ("auto", False):
        ops.reset_launches()
        runs[use_pallas] = repro_torch.diversify(
            x, k=6, measure="remote-clique", metric=metric,
            execution=repro_torch.ExecutionSpec(use_pallas=use_pallas))
        assert (ops.LAUNCHES["pairwise"] > 0) == (use_pallas == "auto")
    kern, plain = runs["auto"], runs[False]
    np.testing.assert_array_equal(kern.indices, plain.indices)
    np.testing.assert_allclose(kern.value, plain.value, rtol=1e-4)
    assert torch.equal(kern.coreset.valid, plain.coreset.valid)


def _grouped_case(n, d, m, bc, seed, device):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn((n, d), generator=g)
    cen = torch.randn((m, bc, d), generator=g)
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    lab = torch.randint(0, m, (n,), generator=g, dtype=torch.int32)
    lab[lab == 1] = 0                               # group 1 empty
    lab[torch.rand((n,), generator=g) < 0.1] = -1   # rows in no group
    return [t.to(device) for t in (pts, cen, mi, lab)]


def _grouped_equal(x, c, mi, lab, mode, p, device):
    """B4 against its plain version: min_out and every group's top-p
    values bit for bit, rows labelled -1 keep min_in, every index in
    [0, n), and the index sets compared through the values they select (a
    -inf fill entry selects nothing)."""
    from repro_torch.kernels.gmm_update import gmm_grouped_topb_cuda
    n, m = x.shape[0], c.shape[0]
    prep = ops.prepare(x, mode)
    cc = (ops._normalize(c) if mode == "cosine" else c).contiguous()
    ops.reset_launches()
    g_min, g_val, g_idx = gmm_grouped_topb_cuda(prep.points, cc, prep.xsq,
                                                mi, lab, mode=mode, p=p)
    assert ops.LAUNCHES["gmm_grouped_topb"] == 1
    r_min, r_val, r_idx = ref.gmm_grouped_topb_ref(prep.points, cc, mi, lab,
                                                   mode, p, xsq=prep.xsq)
    assert torch.equal(g_min, r_min), int((g_min != r_min).sum())
    assert torch.equal(g_min[lab < 0], mi[lab < 0])
    # the plain version keeps min(p, n) entries a group; the kernel's tiles
    # hold at least p rows, so its entries past n are -inf fills
    q = r_val.shape[1]
    assert bool(torch.isneginf(g_val[:, q:]).all())
    g_val, g_idx = g_val[:, :q], g_idx[:, :q]
    assert torch.equal(g_val, r_val)
    assert int(g_idx.min()) >= 0 and int(g_idx.max()) < n
    field = torch.where(lab[None, :] == torch.arange(m, device=device)
                        [:, None], r_min[None, :], float("-inf"))

    def picked(vals, idx):
        return torch.sort(torch.where(torch.isfinite(vals),
                                      torch.gather(field, 1, idx),
                                      float("-inf")), dim=1).values
    assert torch.equal(picked(g_val, g_idx), picked(r_val, r_idx))
    return g_val


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,m,bc", [(4097, 128, 2, 8), (3001, 1000, 64, 8),
                                      (1000, 1000, 16, 3), (5000, 17, 4, 9),
                                      (2500, 64, 4, 1), (33, 5, 16, 8)])
@pytest.mark.parametrize("p", [1, 8, 256])
def test_cuda_grouped_kernel_matches_plain_on_card(cuda_device, mode, n, d,
                                                   m, bc, p):
    """B4 against its plain version, bit for bit: ragged n and d (d = 17
    and 5 take the scalar row loads), bc below, at and above one block of 8
    centers, an empty group, rows labelled -1 (they keep min_in and are
    never candidates), every index in [0, n)."""
    x, c, mi, lab = _grouped_case(n, d, m, bc, n + m + p, cuda_device)
    g_val = _grouped_equal(x, c, mi, lab, mode, p, cuda_device)
    assert bool(torch.isneginf(g_val[1]).all())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [2, 16, 64])
@pytest.mark.parametrize("bc", [1, 3, 8, 9])
def test_cuda_grouped_kernel_tile_structure(cuda_device, mode, m, bc):
    """B4 where a tile holds one group only (the first 1,024 rows, one tile
    at p = 256), a group holds one row, a group is empty (m > 2) and rows
    are labelled -1; ragged n, bit for bit against the plain version."""
    n, d = 5000, 37 if m == 16 else 40
    x, c, mi, lab = _grouped_case(n, d, m, bc, 100 * m + bc, cuda_device)
    single = m - 1
    lab[lab == single] = 0
    lab[n - 1] = single
    lab[:1024] = 0
    g_val = _grouped_equal(x, c, mi, lab, mode, 256, cuda_device)
    assert bool(torch.isfinite(g_val[single, 0]))
    assert bool(torch.isneginf(g_val[single, 1:]).all())


@pytest.mark.parametrize("knobs", [{}, {"kprime": 32, "b": 1},
                                   {"kprime": 8, "b": 4}])
@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique"])
def test_cuda_constrained_with_and_without_kernels(cuda_device, knobs,
                                                   measure):
    rg = np.random.default_rng(9)
    pts = rg.normal(size=(6000, 24)).astype(np.float32)
    lab = rg.integers(0, 5, size=6000).astype(np.int32)
    x = torch.as_tensor(pts, device=cuda_device)
    runs = {}
    for use_pallas in ("auto", False):
        ops.reset_launches()
        runs[use_pallas] = repro_torch.diversify(
            x, k=10, labels=lab, measure=measure,
            execution=repro_torch.ExecutionSpec(use_pallas=use_pallas,
                                                trace=True, **knobs))
        launched = ops.LAUNCHES["gmm_grouped_topb"]
        assert (launched > 0) == (use_pallas == "auto")
    got, want = runs["auto"], runs[False]
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-4)
    assert dict(got.telemetry.counters) == dict(want.telemetry.counters)
    if want.cert is not None:
        assert got.cert.b_schedule == want.cert.b_schedule
        np.testing.assert_allclose(got.cert.group_ratios,
                                   want.cert.group_ratios, rtol=1e-4)
