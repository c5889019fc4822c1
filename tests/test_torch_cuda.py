"""Tests that need a CUDA card: the hand-written kernels against their plain
torch versions, and the engine (batch and streaming) with the kernels
against the engine without them.  They skip without a card (the CUDA
kernels have no CPU mode) and import nothing of JAX, so they run where only
PyTorch for CUDA is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerance: rtol = atol = 3e-5 for the kernels (the reference's kernel
parity); the engine runs must agree exactly on picks and schedules and to
rtol 1e-4 on radii and values (the reference's end-to-end parity).  The B3
kernel and its plain version compute the same chain of rounded products
and adds, so a stream's decisions must be equal on both paths; its d_i
(and the phase log's) agree to rtol 1e-5, which only absorbs a last-ulp
difference of sqrt/acos between the kernel's and torch's math library.
"""
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
                                "pairwise": 0}
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
    # ragged m, n, d; the three tile configurations (narrow n <= 4, medium,
    # wide) all run, and every entry is the same chain in each
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
        torch.testing.assert_close(got, want, **TOL)
        full = ops.pairwise(px.points, py.points, mode, xsq=px.xsq,
                            ysq=py.xsq, prepared=True)
        assert torch.equal(full, got)
        for s in sorted({0, n // 2, n - 1}):
            col = ops.pairwise(px.points, py.points[s:s + 1], mode,
                               xsq=px.xsq,
                               ysq=None if py.xsq is None
                               else py.xsq[s:s + 1], prepared=True)
            assert torch.equal(col[:, 0], full[:, s]), (m, n, d, s)


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
