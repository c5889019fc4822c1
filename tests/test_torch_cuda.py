"""Tests that need a CUDA card: the hand-written kernels against their plain
torch versions, and the engine with the kernels against the engine without
them.  They skip without a card (the CUDA kernels have no CPU mode) and
import nothing of JAX, so they run where only PyTorch for CUDA is
installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerance: rtol = atol = 3e-5 for the kernels (the reference's kernel
parity); the engine runs must agree exactly on picks and schedules and to
rtol 1e-4 on radii and values (the reference's end-to-end parity).
"""
import numpy as np
import pytest
import torch

import repro_torch
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
        assert ops.LAUNCHES == {"gmm_topb": 1, "gmm_update_select": 1}
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
