"""Port parity for ``repro_torch.kernels.ops.gmm_update``, the running-min
compat wrapper: on CPU tensors (the plain version of B2) against the
reference's ``repro.kernels.ops.gmm_update`` (its Pallas kernel in
interpret mode, as the reference's tests run it), for the four metrics
at ragged n, with one center given as a row and as a (b, d) block.

Tolerance: rtol = atol = 3e-5, the reference's own kernel parity
(tests/test_kernels.py): fp32 dot products are summed in another order by
XLA and by torch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro_torch.kernels import ops

MODES = ["sqeuclidean", "euclidean", "dot", "cosine"]
TOL = dict(rtol=3e-5, atol=3e-5)


def _case(n, d, b, seed):
    rg = np.random.default_rng(seed)
    pts = rg.normal(size=(n, d)).astype(np.float32)
    cs = rg.normal(size=(b, d)).astype(np.float32)
    mi = rg.uniform(0.3, 4.0, size=(n,)).astype(np.float32)
    mi[::7] = np.inf
    return pts, cs, mi


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d", [(1, 3), (13, 5), (100, 17), (257, 64)])
def test_gmm_update_matches_the_reference(mode, n, d):
    pts, cs, mi = _case(n, d, 3, n * 31 + d)
    for centers in (cs[0], cs):
        want = rops.gmm_update(jnp.asarray(pts), jnp.asarray(centers),
                               jnp.asarray(mi), mode)
        got = ops.gmm_update(torch.as_tensor(pts), torch.as_tensor(centers),
                             torch.as_tensor(mi), mode)
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

