"""The port's data utilities (``repro_torch.data``) and legacy wrappers
against the reference's (``repro.data``, ``repro.core.diversity_maximize``,
``repro.constrained.fair_*``) on the CPU.

* ``embed_examples``: both branches within rtol 1e-6 of the reference's
  numpy.  The pooled means sum in the reference's order and agree bit for
  bit; a projection is a float32 product whose sums run in another order in
  torch than in numpy's BLAS, so where one goes through a projection the
  entries are also held to an atol of 1e-6 of the largest entry (the
  cancellation of a sum that comes out near zero).
* ``select_diverse`` (batch, ``num_reducers=4``, quotas, a matroid): the
  reference's indices up to proven ties (where picks part, both are equally
  far from the picks before them, rtol 1e-5).
* ``sphere_dataset``, ``clustered_dataset``, ``lm_batch`` (every family)
  and ``stream``: equal bit for bit.
* ``diversity_maximize``, ``fair_diversity_maximize`` and
  ``fair_streaming_diversity``: the reference's results (values to rtol
  1e-4, the end-to-end parity of ROADMAP's ground rules).
"""
import warnings

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.constrained as ref_constrained
import repro.core as ref_core
import repro.data as ref_data
import repro_torch.configs as port_configs
import repro_torch.constrained as port_constrained
import repro_torch.core as port_core
import repro_torch.data as port_data
from repro_torch.constrained.matroid import PartitionMatroid
from repro.constrained.matroid import PartitionMatroid as RefPartition

RTOL = 1e-5


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def _tokens(n=96, s=16, vocab=300, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, s)) \
        .astype(np.int32)


# -- embed_examples ----------------------------------------------------------

@pytest.mark.parametrize("chunk", [2048, 7])
@pytest.mark.parametrize("dim", [24, 8])
def test_embed_examples_table_matches_reference(chunk, dim):
    """Mean-pooled table rows (chunked below N too); dim < D projects."""
    toks = _tokens()
    table = np.random.default_rng(1).normal(size=(300, 24)) \
        .astype(np.float32)
    want = ref_data.embed_examples(toks, embedding=table, dim=dim, seed=3)
    got = port_data.embed_examples(toks, embedding=table, dim=dim, seed=3,
                                   device="cpu", chunk=chunk)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape
    if dim == 24:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_embed_examples_bf16_table_of_a_model():
    """A model's bf16 ``embed`` table pools as its fp32 values do."""
    toks = _tokens(n=40, s=9, vocab=200, seed=4)
    table = torch.randn(200, 16, generator=torch.Generator().manual_seed(0))
    table = table.bfloat16()
    want = ref_data.embed_examples(toks, embedding=table.float().numpy(),
                                   dim=16)
    got = port_data.embed_examples(toks, embedding=table, dim=16, chunk=16)
    assert got.device == table.device
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [16, 64])
def test_embed_examples_sketch_matches_reference(dim):
    toks = _tokens(seed=5)
    want = ref_data.embed_examples(toks, dim=dim, seed=2)
    got = port_data.embed_examples(torch.as_tensor(toks), dim=dim, seed=2)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_embed_examples_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_data.embed_examples(_tokens())


# -- select_diverse ----------------------------------------------------------

def _anticover(pts, idx, j):
    return float(np.linalg.norm(pts[idx[:j]] - pts[idx[j]], axis=1).min())


def _assert_picks(got, want, pts):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for j in range(len(want)):
        if got[j] != want[j]:
            assert np.isclose(_anticover(pts, got, j),
                              _anticover(pts, want, j), rtol=RTOL), j
            return


def _pool(n=400, d=12, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("knobs", [{}, {"num_reducers": 4},
                                   {"num_reducers": 4, "kprime": 16},
                                   {"kprime": 24, "b": 4}, {"b": "auto"}])
def test_select_diverse_matches_reference(knobs):
    emb = _pool()
    with pytest.warns(DeprecationWarning, match="select_diverse"):
        got = port_data.select_diverse(emb, 8, device="cpu", **knobs)
    want = _quiet(ref_data.select_diverse, emb, 8, **knobs)
    _assert_picks(got, want, emb)


@pytest.mark.parametrize("num_reducers", [1, 4])
def test_select_diverse_quotas_and_matroid_match_reference(num_reducers):
    emb = _pool(seed=2)
    lab = np.random.default_rng(3).integers(0, 3, size=len(emb))
    got = _quiet(port_data.select_diverse, emb, 6, group_labels=lab,
                 quotas=[3, 2, 1], num_reducers=num_reducers, device="cpu")
    want = _quiet(ref_data.select_diverse, emb, 6, group_labels=lab,
                  quotas=[3, 2, 1], num_reducers=num_reducers)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    assert np.bincount(lab[got], minlength=3).tolist() == [3, 2, 1]
    got = _quiet(port_data.select_diverse, emb, 6, group_labels=lab,
                 matroid=PartitionMatroid([2, 2, 2]),
                 num_reducers=num_reducers, device="cpu")
    want = _quiet(ref_data.select_diverse, emb, 6, group_labels=lab,
                  matroid=RefPartition([2, 2, 2]),
                  num_reducers=num_reducers)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))


def test_select_diverse_on_a_tensor_stays_on_its_device():
    emb = torch.as_tensor(_pool(n=100))
    got = _quiet(port_data.select_diverse, emb, 5)
    assert len(set(got.tolist())) == 5


# -- pipeline ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_lm_batch_equal_bit_for_bit(arch):
    rcfg = ref_configs.get_config(arch, reduced=True)
    cfg = port_configs.get_config(arch, reduced=True)
    want = ref_data.lm_batch(rcfg, seed=7, step=3, batch=2, seq=12, t_enc=5)
    got = port_data.lm_batch(cfg, seed=7, step=3, batch=2, seq=12, t_enc=5,
                             device="cpu")
    assert got.keys() == want.keys()
    for name in want:
        w = np.asarray(want[name])
        assert got[name].numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_point_clouds_equal_bit_for_bit():
    for got, want in (
            (port_data.sphere_dataset(500, 16, dim=4, seed=3, device="cpu"),
             ref_data.sphere_dataset(500, 16, dim=4, seed=3)),
            (port_data.clustered_dataset(300, 5, dim=6, seed=2,
                                         spread=0.1, device="cpu"),
             ref_data.clustered_dataset(300, 5, dim=6, seed=2, spread=0.1))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_stream_equal_and_point_clouds_default_to_the_card(monkeypatch):
    pts = ref_data.sphere_dataset(103, 4, seed=1)
    want = list(ref_data.stream(pts, 25))
    got = list(port_data.stream(torch.as_tensor(pts), 25))
    assert [len(c) for c in got] == [25, 25, 25, 25, 3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_data.sphere_dataset(10, 2)


# -- legacy wrappers ---------------------------------------------------------

@pytest.mark.parametrize("knobs", [{}, {"kprime": 32}, {"kprime": "auto",
                                                        "b": "auto"}])
def test_diversity_maximize_matches_reference(knobs):
    pts = _pool(n=600, d=3, seed=4)
    with pytest.warns(DeprecationWarning, match="diversity_maximize"):
        sol, value, cs = port_core.diversity_maximize(
            pts, 6, "remote-edge", device="cpu", **knobs)
    rsol, rvalue, rcs = _quiet(ref_core.diversity_maximize, pts, 6,
                               "remote-edge", **knobs)
    np.testing.assert_allclose(sol, np.asarray(rsol), rtol=RTOL)
    np.testing.assert_allclose(value, float(rvalue), rtol=1e-4)
    assert (cs.cert is None) == (rcs.cert is None)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique"])
def test_fair_diversity_maximize_matches_reference(measure):
    pts = _pool(n=300, d=4, seed=5)
    lab = np.random.default_rng(6).integers(0, 3, size=len(pts))
    with pytest.warns(DeprecationWarning,
                      match="fair_diversity_maximize"):
        idx, value, _ = port_constrained.fair_diversity_maximize(
            pts, lab, [2, 2, 1], measure, kprime=8, device="cpu")
    ridx, rvalue, _ = _quiet(ref_constrained.fair_diversity_maximize, pts,
                             lab, [2, 2, 1], measure, kprime=8)
    np.testing.assert_array_equal(np.sort(idx), np.sort(np.asarray(ridx)))
    np.testing.assert_allclose(value, float(rvalue), rtol=1e-4)


def test_fair_streaming_diversity_matches_reference():
    pts = _pool(n=500, d=4, seed=7)
    lab = np.random.default_rng(8).integers(0, 4, size=len(pts))
    with pytest.warns(DeprecationWarning,
                      match="fair_streaming_diversity"):
        sol, labels = port_constrained.fair_streaming_diversity(
            pts, lab, [2, 1, 1, 2], kprime=16, chunk=128, device="cpu")
    rsol, rlabels = _quiet(ref_constrained.fair_streaming_diversity, pts,
                           lab, [2, 1, 1, 2], kprime=16, chunk=128)
    order, rorder = np.lexsort(sol.T), np.lexsort(np.asarray(rsol).T)
    np.testing.assert_allclose(sol[order], np.asarray(rsol)[rorder],
                               rtol=RTOL)
    np.testing.assert_array_equal(np.asarray(labels)[order],
                                  np.asarray(rlabels)[rorder])


def test_legacy_wrappers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _pool(n=50, d=2)
    with pytest.raises(RuntimeError, match="cuda"), \
            pytest.warns(DeprecationWarning):
        port_core.diversity_maximize(pts, 3, "remote-edge")
