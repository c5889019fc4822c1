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


def _sweep_inputs(n, d, b, seed, device):
    """Centers N(0, 1/d), min_in and mask of ``_case`` for n rows."""
    g = torch.Generator().manual_seed(seed)
    cs = torch.randn((b, d), generator=g) / d ** 0.5
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    mask = torch.rand((n,), generator=g) > 0.15
    return [t.to(device) for t in (cs, mi, mask)]


def _hold_sweep(x, c, m, k, mode, p):
    """B1 at top-p and B2 against their plain versions on the same inputs,
    one launch each; the kernel's top-p must also be the stable top-p of
    its own masked min_out, value and index alike (no arithmetic lies
    between them, so ties and their order are held exactly)."""
    ops.reset_launches()
    g_min, g_val, g_idx = ops.gmm_topb(x, c, m, k, mode, p=p)
    u_min, u_arg, u_max = ops.gmm_update_select(x, c, m, k, mode)
    assert ops.LAUNCHES == {"gmm_topb": 1, "gmm_update_select": 1,
                            "pairwise": 0, "gmm_grouped_topb": 0}
    prep = ops.prepare(x, mode)
    cc = ops._normalize(c) if mode == "cosine" else c
    r_min, r_val, r_idx = ref.gmm_topb_ref(prep.points, cc, m, k, mode, p,
                                           xsq=prep.xsq)
    torch.testing.assert_close(g_min, r_min, **TOL)
    torch.testing.assert_close(g_val, r_val, **TOL)
    neg = torch.full_like(r_min, -float("inf"))
    field = torch.where(k, r_min, neg)
    torch.testing.assert_close(torch.sort(field[g_idx]).values,
                               torch.sort(field[r_idx]).values, **TOL)
    own_val, own_idx = ref.topk_stable(torch.where(k, g_min, neg), p)
    assert torch.equal(g_val, own_val) and torch.equal(g_idx, own_idx)
    torch.testing.assert_close(u_min, r_min, **TOL)
    torch.testing.assert_close(u_max, field.max(), **TOL)
    torch.testing.assert_close(ref.take(field, u_arg), field.max(), **TOL)
    own = torch.where(k, u_min, neg)
    assert int(u_arg) == int(torch.argmax(own))
    assert torch.equal(u_max, ref.take(own, u_arg))


@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernels_match_plain_on_card(cuda_device, mode):
    from repro_torch.kernels.gmm_topb import edge_cases, sweep_plan
    for (n, d), b, p in [((4097, 128), 8, 32), ((1000, 17), 3, 1),
                         ((33, 5), 1, 4), ((3000, 64), 12, 256)]:
        _hold_sweep(*_case(n, d, b, n + d, cuda_device), mode, p)
    # the edges of the sweep's plan: one row, a slab less or more one row,
    # a tile and one row, 8,196 rows; d in {1, 3, 5,000, 5,001}, b in
    # {1, 8, 9, 32, 33}, p in {1, 32, 128, 4,096}.  Rows N(0, 1/d), so a
    # dot product's size does not grow with d.
    cases = edge_cases()
    g = torch.Generator().manual_seed(11)
    base = {d: (torch.randn((8196, d), generator=g) / d ** 0.5).to(
        cuda_device) for d in (1, 3, 5000, 5001)}
    for n, d, b, p in cases:
        _hold_sweep(base[d][:n], *_sweep_inputs(n, d, b, n * d + b + p,
                                                 cuda_device), mode, p)
    # equal rows on both sides of every slab border, a fully masked tile,
    # every row masked
    for b, p in ((1, 1), (8, 32), (8, 128), (33, 32)):
        plan = sweep_plan(2 ** 13, p)
        n = 2 * plan.bn + plan.rows + 1
        x, c, m, k = _case(n, 64, b, n + b + p, cuda_device)
        x[plan.rows::plan.rows] = x[plan.rows - 1:n - 1:plan.rows][
            :x[plan.rows::plan.rows].shape[0]]
        inf = torch.full_like(m, float("inf"))
        _hold_sweep(x, c, inf, torch.ones_like(k), mode, p)
        k2 = k.clone()
        k2[plan.bn:2 * plan.bn] = False
        _hold_sweep(x, c, m, k2, mode, p)
        _hold_sweep(x, c, m, torch.zeros_like(k), mode, p)
    # a base 4 bytes off 16: x[1:] of a d = 5,001 array, a d = 5,000 view
    # one float into its storage
    off = base[5001][1:]
    flat = (torch.randn((8196 * 5000 + 1,), generator=g) / 5000 ** 0.5).to(
        cuda_device)[1:].view(8196, 5000)
    assert flat.data_ptr() % 16 == 4
    for x in (off, flat):
        for b, p in ((1, 1), (8, 32), (33, 128)):
            _hold_sweep(x, *_sweep_inputs(*x.shape, b, b + p, cuda_device),
                        mode, p)


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


def _reducer_labels(n, m, contiguous, g):
    """Round-1 labels of a simulated MapReduce run: m equal contiguous
    shards (labels = reducer id, n divisible by m) or random labels over
    m groups (reducer x genre under a constraint)."""
    if contiguous:
        return torch.arange(m, dtype=torch.int32).repeat_interleave(n // m)
    return torch.randint(0, m, (n,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,m,contiguous", [
    (16 * 1031, 200, 16, True),       # equal shards, none a tile multiple
    (9000, 64, 64, False), (9000, 64, 128, False),
    (3 * 2 ** 16, 3, 16, True), (2 ** 16, 3, 64, False)])
@pytest.mark.parametrize("p,bc", [(1, 1), (32, 8)])
def test_cuda_grouped_kernel_at_round1_shapes(cuda_device, mode, n, d, m,
                                              contiguous, p, bc):
    """B4 at the shapes of a simulated MapReduce round 1, bit for bit
    against its plain version: m = 16 contiguous reducer shards (every tile
    edge inside a shard, shard edges inside tiles), random reducer x genre
    labels at m = 64 and 128, and d = 3 with about 2^16 rows per call."""
    g = torch.Generator().manual_seed(n + m + p)
    x = torch.randn((n, d), generator=g)
    c = torch.randn((m, bc, d), generator=g)
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    lab = _reducer_labels(n, m, contiguous, g)
    x, c, mi, lab = [t.to(cuda_device) for t in (x, c, mi, lab)]
    _grouped_equal(x, c, mi, lab, mode, p, cuda_device)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_grouped_kernel_group_spans_a_tile_edge(cuda_device, mode):
    """One group's rows straddle the edge between two 1,024-row tiles (and
    a second edge), the rest of both tiles held by other groups: its top-p
    merges entries from both tiles."""
    n, d, m = 4096, 48, 6
    g = torch.Generator().manual_seed(7)
    x = torch.randn((n, d), generator=g)
    c = torch.randn((m, 8, d), generator=g)
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    lab = torch.randint(2, m, (n,), generator=g, dtype=torch.int32)
    lab[1000:1050] = 0                              # across rows 1023/1024
    lab[2040:3100] = 1                              # across 2047/2048, 3071
    x, c, mi, lab = [t.to(cuda_device) for t in (x, c, mi, lab)]
    g_val = _grouped_equal(x, c, mi, lab, mode, 64, cuda_device)
    # group 0 holds 50 rows (its tail is -inf fill), group 1 over 64
    assert bool(torch.isfinite(g_val[0, :50]).all())
    assert bool(torch.isneginf(g_val[0, 50:]).all())
    assert bool(torch.isfinite(g_val[1]).all())


@pytest.mark.parametrize("measure,knobs", [
    ("remote-edge", {}), ("remote-edge", {"kprime": 32, "b": 1}),
    ("remote-clique", {"kprime": 16, "b": 4, "partition": "random"}),
    ("remote-clique", {"kprime": 16, "generalized": True}),
    ("remote-edge", {"kprime": 24, "partition": "adversarial",
                     "labels": True})])
def test_cuda_mapreduce_with_and_without_kernels(cuda_device, measure, knobs):
    """The simulated MapReduce facade at a small size: round 1 of all
    reducers runs through B4 (one launch per fold), and kernel and plain
    runs give the same picks, value and counters."""
    knobs = dict(knobs)
    rg = np.random.default_rng(11)
    pts = rg.normal(size=(8000, 24)).astype(np.float32)
    lab = (rg.integers(0, 4, size=8000).astype(np.int32)
           if knobs.pop("labels", False) else None)
    x = torch.as_tensor(pts, device=cuda_device)
    runs = {}
    for use_pallas in ("auto", False):
        ops.reset_launches()
        runs[use_pallas] = repro_torch.diversify(
            x, k=8, labels=lab, measure=measure,
            execution=repro_torch.ExecutionSpec(
                mode="mapreduce", num_reducers=4, use_pallas=use_pallas,
                trace=True, **knobs))
        launched = ops.LAUNCHES["gmm_grouped_topb"]
        assert (launched > 0) == (use_pallas == "auto")
    got, want = runs["auto"], runs[False]
    np.testing.assert_array_equal(got.solution, want.solution)
    if want.indices is not None:
        np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-4)
    assert dict(got.telemetry.counters) == dict(want.telemetry.counters)
    if want.cert is not None:
        assert got.cert.b_schedule == want.cert.b_schedule


@pytest.mark.parametrize("mode", MODES)
def test_cuda_grouped_kernel_at_the_serving_shape(cuda_device, mode):
    """B4 at the fused rerank's shape: m = 256 requests of 1,024 rows
    each, one center a group (bc = 1), p = 1, bit for bit against its plain
    version.  Each 1,024-row tile holds one request and writes a slot for
    all 256."""
    n, d, m = 256 * 1024, 64, 256
    g = torch.Generator().manual_seed(16)
    x = torch.randn((n, d), generator=g)
    c = torch.randn((m, 1, d), generator=g)
    mi = torch.rand((n,), generator=g) * 3.7 + 0.3
    lab = _reducer_labels(n, m, True, g)
    x, c, mi, lab = [t.to(cuda_device) for t in (x, c, mi, lab)]
    _grouped_equal(x, c, mi, lab, mode, 1, cuda_device)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_rerank_batched_kernel_equals_plain(cuda_device, metric, ragged):
    """The fused rerank with B4 against the same run on plain torch:
    indices, radii and values equal, one B4 launch a fold (k folds)."""
    from repro_torch.serving import rerank_batched

    rg = np.random.default_rng(5)
    if ragged:
        cands = [torch.as_tensor(rg.normal(size=(n, 48)).astype(np.float32),
                                 device=cuda_device)
                 for n in rg.integers(64, 129, size=32)]
    else:
        cands = torch.as_tensor(rg.normal(size=(32, 128, 48)).astype(
            np.float32), device=cuda_device)
    ops.reset_launches()
    got = rerank_batched(cands, k=12, metric=metric)
    assert ops.LAUNCHES["gmm_grouped_topb"] == 12
    assert sum(ops.LAUNCHES.values()) == 12
    want = rerank_batched(cands, k=12, metric=metric, use_pallas=False)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.radii, want.radii)
    np.testing.assert_array_equal(got.values, want.values)


def test_cuda_session_reranker_kernel_equals_plain(cuda_device):
    """Sessions on the card (B3 chunk filters, B4 fused solves) against
    the same sessions on plain torch: slates, certificates and counters."""
    from repro_torch.serving import OnlineReranker

    rg = np.random.default_rng(6)
    rr = {up: OnlineReranker(k=8, dim=32, kprime=32, metric="cosine",
                             use_pallas=up) for up in ("auto", False)}
    for rnd in range(4):
        batch = {f"s{s}": torch.as_tensor(
            (rg.normal(size=(96, 32)) + s).astype(np.float32),
            device=cuda_device) for s in range(6)}
        out = {up: r.rerank_many(batch) for up, r in rr.items()}
        for key in batch:
            a, b = out["auto"][key], out[False][key]
            np.testing.assert_array_equal(a.slate, b.slate)
            assert a.reused == b.reused and a.cert == b.cert
    assert rr["auto"].stats() == rr[False].stats()


@pytest.mark.parametrize("measure,knobs", [
    ("remote-edge", {}), ("remote-clique", {"kprime": 16, "b": 1}),
    ("remote-edge", {"kprime": 24, "labels": True})])
def test_cuda_per_reducer_round1_equals_grouped(cuda_device, measure, knobs):
    """trace="reducers" and a retried reducer run round 1 one reducer at a
    time (4 x the B4 launches); the result is torch.equal to the one-run
    grouped round 1."""
    from repro_torch.distributed import FailureInjector, ResiliencePolicy

    knobs = dict(knobs)
    rg = np.random.default_rng(12)
    pts = rg.normal(size=(8000, 24)).astype(np.float32)
    lab = (rg.integers(0, 4, size=8000).astype(np.int32)
           if knobs.pop("labels", False) else None)
    x = torch.as_tensor(pts, device=cuda_device)

    def round1_launches(res):
        def find(spans):
            for s in spans:
                if s.name == "mr.round1":
                    return s
                hit = find(s.children)
                if hit is not None:
                    return hit
        return find(res.telemetry.spans).attrs["launches"][
            "gmm_grouped_topb"]

    runs, launches = {}, {}
    for name, extra in (("grouped", dict(trace=True)),
                        ("reducers", dict(trace="reducers")),
                        ("retry", dict(trace=True, resilience=ResiliencePolicy(
                            injector=FailureInjector(
                                fail_at=("reducer:2",)))))):
        ops.reset_launches()
        runs[name] = repro_torch.diversify(
            x, k=8, labels=lab, measure=measure,
            execution=repro_torch.ExecutionSpec(
                mode="mapreduce", num_reducers=4, **extra, **knobs))
        launches[name] = round1_launches(runs[name])
    base = runs["grouped"]
    for name in ("reducers", "retry"):
        got = runs[name]
        np.testing.assert_array_equal(got.solution, base.solution)
        assert got.value == base.value and got.cert == base.cert
        if base.coreset is not None:
            assert torch.equal(got.coreset.points, base.coreset.points)
        assert launches[name] == 4 * launches["grouped"]


# --------------------------------------------------------------------------
# dynamic mode: cover maintenance through B3, the query through B1
# --------------------------------------------------------------------------

def _dyn_state(idx):
    """Every ``state_dict`` array of an index, and its meta."""
    arrays, meta = idx.state_dict()
    return arrays, meta


def _assert_same_index(a, b):
    (xa, ma), (xb, mb) = _dyn_state(a), _dyn_state(b)
    assert ma == mb
    for name in xa:
        assert xa[name].dtype == xb[name].dtype, name
        assert torch.equal(torch.as_tensor(xa[name]),
                           torch.as_tensor(xb[name])), name


@pytest.mark.parametrize("case", ["ragged_tail", "duplicates", "cosine_5000"])
def test_cuda_blocked_greedy_kernel_equals_plain(cuda_device, case,
                                                monkeypatch):
    """The blocked greedy with B3 tiles against the same greedy with the
    plain tiles, on the card: the built levels are equal entry for entry.
    Ragged point counts with a block-size tail, exact duplicates (every
    point three times, so distances of 0 and exact ties), and cosine at
    the musiXmatch width."""
    from repro_torch.dynamic import DynamicIndex, levels

    rg = np.random.default_rng(21)
    if case == "cosine_5000":
        pts = rg.poisson(0.05, size=(1501, 5000)).astype(np.float32)
        pts[:, 0] += 1.0
        metric, block = "cosine", 256
    elif case == "duplicates":
        base = rg.normal(size=(700, 8)).astype(np.float32) * 10
        pts = np.concatenate([base, base[::-1], base])
        metric, block = "euclidean", 300
    else:
        pts = rg.normal(size=(3001, 8)).astype(np.float32) * 10
        metric, block = "euclidean", 1000
    x = torch.as_tensor(pts, device=cuda_device)
    monkeypatch.setattr(levels, "BLOCK", block)
    idx = {}
    for up in ("auto", False):
        ops.reset_launches()
        idx[up] = DynamicIndex(dim=pts.shape[1], metric=metric, budget=64,
                               use_pallas=up)
        idx[up].insert(x)
        launched = dict(ops.LAUNCHES)
        assert (launched["pairwise"] > 0) == (up == "auto"), launched
    _assert_same_index(idx["auto"], idx[False])


def test_cuda_dynamic_churn_kernel_equals_plain(cuda_device, monkeypatch):
    """A churned index on the card — inserts, deletes of centers and
    members, a rebuild — with the kernels (B3 maintenance, B1 query)
    against the same index on plain torch: equal structure, the same
    query ids and level every round, certificates to rtol 1e-5."""
    from repro_torch.dynamic import DynamicIndex, RebuildPolicy, levels

    rg = np.random.default_rng(22)
    monkeypatch.setattr(levels, "BLOCK", 512)
    idx = {up: DynamicIndex(dim=8, budget=48, use_pallas=up,
                            policy=RebuildPolicy(max_deleted_frac=0.3))
           for up in ("auto", False)}
    alive = []
    for rnd in range(8):
        pts = torch.as_tensor(rg.normal(size=(1500 if rnd == 0 else 300, 8))
                              .astype(np.float32) * 10, device=cuda_device)
        for up, ix in idx.items():
            ops.reset_launches()
            ids = ix.insert(pts)
            if up == "auto":
                assert ops.LAUNCHES["pairwise"] > 0
        alive.extend(ids.tolist())
        kill = sorted(rg.choice(alive, size=250, replace=False).tolist())
        alive = [i for i in alive if i not in set(kill)]
        q = {}
        for up, ix in idx.items():
            ix.delete(kill)
            ops.reset_launches()
            q[up] = ix.query(6)
            assert (ops.LAUNCHES["gmm_topb"] > 0) == (up == "auto")
        np.testing.assert_array_equal(q["auto"].ids, q[False].ids)
        assert q["auto"].level == q[False].level
        a, b = q["auto"].cert.to_dict(), q[False].cert.to_dict()
        for f in a:
            if isinstance(a[f], float):
                np.testing.assert_allclose(a[f], b[f], rtol=1e-5)
            elif f != "radii":
                assert a[f] == b[f], f
        np.testing.assert_allclose(a["radii"], b["radii"], rtol=1e-5)
        _assert_same_index(idx["auto"], idx[False])
    assert idx["auto"].rebuilds >= 2


def test_cuda_dynamic_save_restores_on_cpu(cuda_device, tmp_path):
    """An index saved on the card restores on the CPU with the same arrays
    and answers the same query (integer-lattice points: every distance is
    exact on both devices)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dynamic import DynamicIndex

    rg = np.random.default_rng(23)
    pts = rg.integers(-50, 51, size=(2000, 6)).astype(np.float32)
    idx = DynamicIndex(dim=6, budget=32)
    ids = idx.insert(torch.as_tensor(pts, device=cuda_device))
    idx.delete(ids[::7])
    mgr = CheckpointManager(str(tmp_path))
    idx.save(mgr, 2)
    back, step = DynamicIndex.restore(mgr, device="cpu")
    assert step == 2 and back.device.type == "cpu"
    _assert_same_index(idx, back)
    qa, qb = idx.query(5), back.query(5)
    np.testing.assert_array_equal(qa.ids, qb.ids)
    assert qa.cert.radius == qb.cert.radius
    assert qa.cert.counts == qb.cert.counts


# -- the model-backed serving path ---------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma-2b",
                                  "starcoder2-15b", "gemma2-27b"])
def test_cuda_model_forward_matches_cpu(cuda_device, arch):
    """A reduced model's forward (and its prefill + decode from the cache)
    on the card against the same weights on the CPU, at the reference's
    logits bound rtol = atol = 2e-2: cuBLAS and the CPU sum bf16 products
    in different orders."""
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.models import transformer

    cfg = get_config(arch, reduced=True)
    cpu = M.init_params(cfg, 0, device="cpu")
    card = params_from_reference(params_to_reference(cpu), cfg,
                                 device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 20)))
    pos = torch.arange(20, dtype=torch.int32)
    with torch.no_grad():
        want = transformer.forward(cpu, cfg, None, toks, pos)[0]
        got = transformer.forward(card, cfg, None, toks.to(cuda_device),
                                  pos.to(cuda_device))[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)
    cache = M.make_cache(cfg, 2, 24, device=cuda_device)
    _, cache = M.prefill_fn(card, cfg, None,
                            {"tokens": toks[:, :19].to(cuda_device)}, cache)
    step, _ = M.decode_fn(card, cfg, None, toks[:, 19:].to(cuda_device),
                          torch.tensor(19, device=cuda_device), cache)
    np.testing.assert_allclose(step[:, -1].cpu().numpy(),
                               want[:, -1].numpy(), rtol=2e-2, atol=2e-2)


def test_cuda_engine_generates_on_the_card(cuda_device):
    """The engine runs where its model is: the tokens are the vocab's and
    two runs give the same ones."""
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("internlm2-1.8b", reduced=True)
    engine = ServingEngine(cfg, None, M.init_params(cfg, 0,
                                                    device=cuda_device),
                           batch=4, capacity=32)
    assert engine.device.type == "cuda"
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               .astype(np.int32) for n in rng.integers(3, 10, size=6)]
    a, b = ([Request(prompt=p, max_new_tokens=8) for p in prompts]
            for _ in range(2))
    engine.generate(a)
    engine.generate(b)
    for x, y in zip(a, b):
        assert x.out.shape == (8,) and x.out.max() < cfg.vocab_size
        np.testing.assert_array_equal(x.out, y.out)


@pytest.mark.parametrize("dim", [32, 8])
def test_cuda_embed_examples_matches_cpu(cuda_device, dim):
    """Mean pooling through a bf16 table sums in the same order on both
    devices (equal bit for bit); the projection (dim < D) is an fp32
    product in another order on the card, held to rtol 1e-6 and 1e-6 of
    the largest entry; the histogram sketch likewise."""
    from repro_torch.data import embed_examples

    g = torch.Generator().manual_seed(3)
    table = torch.randn(500, 32, generator=g).bfloat16()
    toks = torch.randint(0, 500, (3000, 16), generator=g)
    want = embed_examples(toks, embedding=table, dim=dim, chunk=512)
    got = embed_examples(toks, embedding=table.to(cuda_device), dim=dim,
                         chunk=512)
    assert got.device.type == "cuda"
    tol = dict(rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    if dim == 32:
        assert torch.equal(got.cpu(), want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
    sk = embed_examples(toks, dim=dim, device=cuda_device)
    sk_cpu = embed_examples(toks, dim=dim, device="cpu")
    np.testing.assert_allclose(sk.cpu().numpy(), sk_cpu.numpy(), rtol=1e-6,
                               atol=1e-6 * float(sk_cpu.abs().max()))


# -- dense-model training -------------------------------------------------------

def _train_pair(device, lr=1e-4, steps=1):
    """``steps`` AdamW steps of the reduced internlm2 on ``device`` from the
    seed-0 weights; (losses, grad norms, params)."""
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.train import AdamW, make_train_step

    cfg = get_config("internlm2-1.8b", reduced=True)
    tree = params_from_reference(params_to_reference(
        M.init_params(cfg, 0, device="cpu")), cfg, device=device)
    opt = AdamW()
    state = opt.init(tree)
    step = make_train_step(cfg, None, opt, lambda s: lr)
    losses, norms = [], []
    for i in range(steps):
        batch = lm_batch(cfg, seed=7, step=i, batch=4, seq=16, device=device)
        tree, state, m = step(tree, state, batch, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, tree


class _GradProbe:
    """An optimizer that keeps a float64 host copy of the gradients a train
    step hands it, leaf by leaf, and changes nothing."""

    grads = None

    def init(self, params):
        return ()

    def update(self, grads, state, params, lr):
        from repro_torch.tree import tree_leaves
        self.grads = [g.detach().double().cpu() for g in tree_leaves(grads)]
        return params, state


def _step_grads(device, dtype, rows=4):
    """(loss, gradients) of one ``make_train_step`` of the reduced internlm2
    on ``device``, from the seed-0 weights cast to ``dtype``, on the first
    ``rows`` rows of the batch."""
    import dataclasses

    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map

    base = get_config("internlm2-1.8b", reduced=True)
    cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
    tree = tree_map(lambda t: t.to(dtype), params_from_reference(
        params_to_reference(M.init_params(base, 0, device="cpu")), base,
        device=device))
    batch = lm_batch(base, seed=7, step=0, batch=4, seq=16, device=device)
    probe = _GradProbe()
    step = make_train_step(cfg, None, probe, lambda s: 1e-4)
    _, _, m = step(tree, (), {k: v[:rows] for k, v in batch.items()}, 0)
    return float(m["loss"]), probe.grads


def _fro(a, b):
    return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))


def test_cuda_train_step_matches_cpu(cuda_device):
    """The gradients one reduced train step hands its optimizer, on the
    card against the CPU (TF32 off), by the largest per-leaf relative
    Frobenius error: fp32 within 1e-3 (the fp32 gradient parts from the
    float64 one by 3e-5 on the CPU), bf16 within 0.15 (the bound of the
    bf16 gradient parity with the reference, tests/test_torch_train.py:
    the random model is chaotic in bf16).  A step that drops half the
    batch reads 0.78-1.24 on the CPU and must read above the bound here
    too.  The loss to rtol 2e-3 (the forward's logits agree to the
    reference's 2e-2, the loss is their mean over 64 tokens)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    for dtype, bound in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
        (cl, cg), (gl, gg) = (_step_grads("cpu", dtype),
                              _step_grads(cuda_device, dtype))
        assert gl == pytest.approx(cl, rel=2e-3), dtype
        err = _fro(gg, cg)
        half = _fro(_step_grads(cuda_device, dtype, rows=2)[1], cg)
        print(f"{dtype}: card against CPU {err:.3e}, half batch {half:.3e}"
              f" (bound {bound:g})")
        assert err <= bound, (dtype, err)
        assert half > bound, (dtype, half)


def test_cuda_train_steps_repeat_bit_for_bit(cuda_device):
    """Three steps twice from the same state give the same params and
    losses: no backward of the step adds with atomics (the embedding's is
    ``F.embedding``'s), so a resumed run can equal an uninterrupted one."""
    from repro_torch.tree import tree_leaves
    a, b = _train_pair(cuda_device, 1e-3, 3), _train_pair(cuda_device, 1e-3,
                                                           3)
    assert a[0] == b[0] and a[1] == b[1]
    for x, y in zip(tree_leaves(a[2]), tree_leaves(b[2])):
        assert torch.equal(x, y)


def test_cuda_fp32_gradient_against_a_central_difference(cuda_device):
    """The fp32 gradient of the reduced model on the card against a central
    difference of its fp32 loss along a random unit direction, step 1e-3:
    relative error at most 2e-2 (as on the CPU, tests/test_torch_train.py)."""
    import dataclasses

    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.train import make_loss
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.train.step import _value_and_grad

    cfg = get_config("internlm2-1.8b", reduced=True)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    w = tree_map(lambda t: t.float(),
                 M.init_params(cfg, 0, device=cuda_device))
    batch = lm_batch(cfg, seed=1, step=0, batch=4, seq=16,
                     device=cuda_device)
    loss_fn = make_loss(cfg32, None)
    _, grads = _value_and_grad(loss_fn, w, batch)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    d = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                       device=cuda_device), w)
    norm = torch.sqrt(sum((x * x).sum() for x in tree_leaves(d)))
    d = tree_map(lambda x: x / norm, d)
    dot = float(sum((g * x).sum() for g, x in zip(tree_leaves(grads),
                                                  tree_leaves(d))))
    eps = 1e-3
    with torch.no_grad():
        lp = float(loss_fn(tree_map(lambda t, x: t + eps * x, w, d), batch))
        lm = float(loss_fn(tree_map(lambda t, x: t - eps * x, w, d), batch))
    rel = abs((lp - lm) / (2 * eps) - dot) / abs(dot)
    assert rel <= 2e-2, rel


def test_cuda_moe_layer_with_drops_matches_cpu(cuda_device):
    """One MoE layer at granite-moe-1b-a400m's width (D 1,024, 32 experts,
    top-8, F 512) on 1,024 tokens at capacity factor 0.5, where drops
    occur, in fp32 on the card and on the CPU from the same inputs.  The
    dispatch, as an (N, E) table of each (token, expert)'s buffer row (C
    where dropped, -1 where not routed: free of the order of a token's
    slots), is equal entry for entry unless a token routes differently on
    a proven near-tie (the gap between its 8th and 9th logit no larger
    than the largest logit difference of the tokens that agree); such a
    token's entries and, after it, the moved experts' are not compared.
    The outputs of the other tokens agree at rtol 1e-4 and an atol of 1e-4
    of the largest entry (two fp32 summation orders over D).  The layer
    reads nothing back to the host as far as CUDA's sync debug mode can
    tell (set to raise; torch calls it a prototype that does not see
    every synchronizing operation)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              capacity_factor=0.5, dtype=torch.float32,
                              param_dtype=torch.float32)
    N, D, E, F = 1024, cfg.d_model, cfg.num_experts, cfg.d_ff
    k = cfg.num_experts_per_tok
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1, N, D, generator=gen)
    ws = [torch.randn(E, D, F, generator=gen) / D ** 0.5,
          torch.randn(E, D, F, generator=gen) / D ** 0.5,
          torch.randn(E, F, D, generator=gen) / F ** 0.5]
    router = torch.randn(D, E, generator=gen) / D ** 0.5
    seen = {}
    real = moe._dispatch_local

    def record(side):
        def fn(xf, logits, E_range, c):
            out = real(xf, logits, E_range, c)
            keep, _, dest_c, _, C = out[1]
            top = torch.topk(logits, k).indices
            table = torch.full((N, E), -1, dtype=torch.long,
                               device=logits.device).scatter_(
                1, top, torch.where(keep, dest_c, C).view(N, k).long())
            seen[side] = (logits.cpu(), table.cpu(), int((~keep).sum()))
            return out
        return fn
    on_card = [t.to(cuda_device) for t in (x, router, *ws)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_mlp(*on_card[:2], *on_card[2:], cfg, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moe._dispatch_local = record("cpu")
    try:
        want = moe.moe_mlp(x, router, *ws, cfg, None)
        moe._dispatch_local = record("card")
        got = moe.moe_mlp(x.to(cuda_device), router.to(cuda_device),
                          *(w.to(cuda_device) for w in ws), cfg, None).cpu()
    finally:
        moe._dispatch_local = real
    (lc, tc, drops), (lg, tg, _) = seen["cpu"], seen["card"]
    assert drops > 0
    tops = [torch.topk(v, k).indices for v in (lc, lg)]
    sets = [t.sort(-1).values for t in tops]
    differ = (sets[0] != sets[1]).any(-1)
    bound = float((lc - lg).abs()[~differ].max())
    vals = [torch.topk(v, k + 1).values for v in (lc, lg)]
    skip = torch.zeros(N, E, dtype=torch.bool)
    for t in differ.nonzero().flatten().tolist():
        assert max(float(v[t, k - 1] - v[t, k]) for v in vals) <= bound, t
        moved = sorted(set(tops[0][t].tolist()) ^ set(tops[1][t].tolist()))
        skip[t] = True
        skip[t:, moved] = True
    assert torch.equal(tc[~skip], tg[~skip])
    rows = ~(skip & ((tc >= 0) | (tg >= 0))).any(-1)
    np.testing.assert_allclose(got[0, rows].numpy(), want[0, rows].numpy(),
                               rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


# -- the vlm and ssm families ---------------------------------------------------

@pytest.mark.parametrize("s", [96, 50])
def test_cuda_ssd_scan_and_recurrence_match_cpu(cuda_device, s):
    """``ssd_chunked`` and the step recurrence on the card against the CPU
    from the same fp32 inputs (3 chunks of 32, or 2 of 25), y and the final
    state within rtol 1e-5 and an atol of 1e-5 of the largest entry
    (cuBLAS and the CPU sum the chunk products in other orders); on the
    card the two paths agree in float64 within 1e-10 (relative
    Frobenius)."""
    from repro_torch.models import ssd

    rng = np.random.default_rng(s)
    ins = [rng.normal(size=(2, s, 3, 8)), -rng.uniform(0.01, 0.6, (2, s, 3)),
           rng.normal(size=(2, s, 16)) / 2, rng.normal(size=(2, s, 16)) / 2]
    cpu = [torch.as_tensor(a, dtype=torch.float32) for a in ins]
    card = [t.to(cuda_device) for t in cpu]
    zero = torch.zeros((2, 3, 8, 16))
    for fn in (lambda t, z: ssd.ssd_chunked(*t, 32),
               lambda t, z: ssd._ssd_recurrent(*t, z)):
        want = fn(cpu, zero)
        got = fn(card, zero.to(cuda_device))
        for g, w in zip(got, want):
            assert g.device == card[0].device
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))
    wide = [t.double() for t in card]
    y, final = ssd.ssd_chunked(*wide, 32)
    y_r, final_r = ssd._ssd_recurrent(*wide, zero.double().to(cuda_device))
    for a, b in ((y, y_r), (final, final_r)):
        assert float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)) <= 1e-10


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "mamba2-130m"])
def test_cuda_vlm_and_ssm_forward_match_cpu(cuda_device, arch):
    """A reduced vlm (patch embeddings before the tokens) or ssm model's
    forward on the card against the same weights on the CPU, and its
    prefill + decode from the cache against the card's full forward, at
    the reference's logits bound rtol = atol = 2e-2."""
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_reference, params_to_reference

    cfg = get_config(arch, reduced=True)
    cpu = M.init_params(cfg, 0, device="cpu")
    card = params_from_reference(params_to_reference(cpu), cfg,
                                 device=cuda_device)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)))
    batch = {"tokens": toks, "labels": toks}
    P = cfg.num_patches
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(2, P, 1024)), dtype=torch.float32)
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}

    def logits(model, b):
        from repro_torch.models import ssd, vlm
        with torch.no_grad():
            if cfg.family == "vlm":
                return vlm.forward_train(model, cfg, None, b["tokens"],
                                         b["patch_embeds"])[0]
            return ssd.forward(model, cfg, None, b["tokens"])[0]

    want, got = logits(cpu, batch), logits(card, on_card)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)
    cache = M.make_cache(cfg, 2, P + 24, device=cuda_device)
    pre = dict(on_card, tokens=on_card["tokens"][:, :19])
    _, cache = M.prefill_fn(card, cfg, None, pre, cache)
    step, _ = M.decode_fn(card, cfg, None, on_card["tokens"][:, 19:],
                          torch.tensor(P + 19, device=cuda_device), cache)
    np.testing.assert_allclose(step[:, -1].cpu().numpy(),
                               got[:, -1].cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


# -- the hybrid and encdec families ------------------------------------------------

@pytest.mark.parametrize("s", [1, 37, 64])
def test_cuda_associative_scan_matches_cpu(cuda_device, s):
    """The RG-LRU's scan (``rglru._lru_scan``: ``associative_scan`` of its
    combine with h0 folded in) on the card against the CPU from the same
    fp32 inputs, within rtol 1e-5 and an atol of 1e-5 of the largest
    entry; on the card, in float64, within 1e-10 (relative Frobenius) of
    the sequential loop."""
    from repro_torch.models import rglru

    rng = np.random.default_rng(s)
    a = torch.as_tensor(rng.uniform(0.2, 1.0, (2, s, 24)),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(2, s, 24)), dtype=torch.float32)
    h0 = torch.as_tensor(rng.normal(size=(2, 24)), dtype=torch.float32)
    want = rglru._lru_scan(a, b, h0)
    got = rglru._lru_scan(*(t.to(cuda_device) for t in (a, b, h0)))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    a64, b64, h = (t.double().to(cuda_device) for t in (a, b, h0))
    loop = []
    for t in range(s):
        h = a64[:, t] * h + b64[:, t]
        loop.append(h)
    scan = rglru._lru_scan(a64, b64, h0.double().to(cuda_device))
    loop = torch.stack(loop, dim=1)
    assert float(torch.linalg.vector_norm(scan - loop)
                 / torch.linalg.vector_norm(loop)) <= 1e-10


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "seamless-m4t-large-v2"])
def test_cuda_hybrid_and_encdec_forward_match_cpu(cuda_device, arch):
    """A reduced hybrid (cut to 4 layers, 1 leading layer and 1 group: at
    5 the random bf16 model is chaotic, ``test_torch_rglru.py``) or encdec
    model's forward on the card against the same weights on the CPU, and
    its prefill + decode from the cache against the card's full forward
    (20 tokens: the hybrid's decode wraps its 16-slot buffer; the encdec
    model's after 10 frames), at the reference's logits bound rtol = atol
    = 2e-2."""
    import dataclasses

    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.models import encdec, rglru

    cfg = get_config(arch, reduced=True)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=4)
    cpu = M.init_params(cfg, 0, device="cpu")
    card = params_from_reference(params_to_reference(cpu), cfg,
                                 device=cuda_device)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)))
    frames = torch.as_tensor(rng.normal(size=(2, 10, cfg.d_model)),
                             dtype=torch.float32)

    def logits(model, t, f):
        with torch.no_grad():
            if cfg.family == "encdec":
                return encdec.forward_train(model, cfg, None, f, t)[0]
            pos = torch.arange(t.shape[1], dtype=torch.int32,
                               device=t.device)
            return rglru.forward(model, cfg, None, t, pos)[0]

    want = logits(cpu, toks, frames)
    t, f = toks.to(cuda_device), frames.to(cuda_device)
    got = logits(card, t, f)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)
    cache = M.make_cache(cfg, 2, 24, t_enc=10, device=cuda_device)
    pre = ({"frames": f, "dec_tokens": t[:, :19]} if cfg.family == "encdec"
           else {"tokens": t[:, :19]})
    _, cache = M.prefill_fn(card, cfg, None, pre, cache)
    step, _ = M.decode_fn(card, cfg, None, t[:, 19:],
                          torch.tensor(19, device=cuda_device), cache)
    np.testing.assert_allclose(step[:, -1].cpu().numpy(),
                               got[:, -1].cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
