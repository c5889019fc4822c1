"""Port parity for the matroid oracles (``repro_torch.constrained.matroid``,
the port's own numpy copy): every oracle method against the reference's on
the same count vectors, labels and candidate sets.  The oracles are exact
integer arithmetic, so answers must be equal.
"""
import numpy as np
import pytest

from repro.constrained import matroid as rmat
from repro_torch.constrained import matroid as pmat


def _pairs(rng):
    """(port oracle, reference oracle) built from the same arguments."""
    elig = rng.random((3, 4)) < 0.6
    elig[np.arange(3), rng.integers(0, 4, size=3)] = True
    specs = [
        ("PartitionMatroid", ([2, 1, 2],), {}),
        ("PartitionMatroid", (), dict(q_min=[1, 0, 0], q_max=[3, 2, 2],
                                      k=4)),
        ("PartitionMatroid", (), dict(q_min=[0, 0], q_max=[4, 4], k=3)),
        ("TransversalMatroid", (elig,), {}),
        ("TransversalMatroid", (np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]],
                                         bool),), dict(k=2)),
        ("LaminarMatroid", (4, [([0, 1], 2), ([2], 1), ([0, 1, 2, 3], 4)]),
         {}),
        ("LaminarMatroid", (3, [([0], 1), ([1], 1), ([0, 1, 2], 3)]), {}),
    ]
    for name, args, kw in specs:
        yield getattr(pmat, name)(*args, **kw), getattr(rmat, name)(*args,
                                                                     **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_answer_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    for got, want in _pairs(rng):
        assert (got.m, got.k) == (want.m, want.k)
        for _ in range(40):
            counts = rng.integers(0, 4, size=got.m)
            assert got.counts_feasible(counts) == want.counts_feasible(
                counts)
            assert got.basis_feasible(counts) == want.basis_feasible(counts)
            np.testing.assert_array_equal(got.grow_mask(counts),
                                          want.grow_mask(counts))
            g = int(rng.integers(0, got.m))
            np.testing.assert_array_equal(got.swap_mask(counts, g),
                                          want.swap_mask(counts, g))
        labels = rng.integers(0, got.m, size=12)
        sel = labels[rng.permutation(12)[:got.k]]
        assert got.independence_oracle(sel) == want.independence_oracle(sel)
        assert got.rank(labels) == want.rank(labels)
        assert got.search_space_size(labels) == want.search_space_size(
            labels)
        avail = np.bincount(labels, minlength=got.m)
        assert [tuple(c) for c in got.basis_count_vectors(avail)] == \
            [tuple(c) for c in want.basis_count_vectors(avail)]


def test_as_matroid_and_derive_mk_like_the_reference():
    got, want = pmat.as_matroid(quotas=[1, 2]), rmat.as_matroid(quotas=[1, 2])
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.quotas, want.quotas)
    lam = pmat.LaminarMatroid(3, [([0, 1], 2)], k=2)
    assert pmat.as_matroid(lam) is lam
    assert pmat.derive_mk(lam, None, None, "f") == rmat.derive_mk(
        rmat.LaminarMatroid(3, [([0, 1], 2)], k=2), None, None, "f")
    assert pmat.derive_mk(None, 4, 6, "f") == rmat.derive_mk(None, 4, 6, "f")
    for mod in (pmat, rmat):
        with pytest.raises(ValueError):
            mod.as_matroid()
        with pytest.raises(ValueError):
            mod.derive_mk(None, None, 3, "f")


def test_validate_ground_set_rejects_like_the_reference():
    for mod in (pmat, rmat):
        pm = mod.PartitionMatroid([2, 2])
        pm.validate_ground_set(np.array([0, 0, 1, 1, 1]))
        with pytest.raises(ValueError):
            pm.validate_ground_set(np.array([0, 1, 1]))      # group 0 < 2
        with pytest.raises(ValueError):
            pm.validate_ground_set(np.array([0, 0, 1, 1, 2]))  # label 2
