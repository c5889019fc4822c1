"""The port's model-backed serving engine (``repro_torch.serving.engine``)
against the reference's (``repro.serving.engine``) on the CPU, on the same
weights (the reference's init, carried by ``interop.params_from_reference``)
and the same prompts.

* ``generate``: greedy tokens equal step by step.  The two run bf16 in
  different orders, so their logits agree to about the reference's own
  cache-consistency bound (2e-2) and a greedy pick can part at a near-tie:
  a row's tokens must be equal up to the first step where they part, and
  there the reference's top-2 logit gap must be under 4e-2 (twice the
  bound); the row is not compared past it.  The count of compared steps
  is printed and must be most of them.
* ``rerank_group`` / ``generate_diverse`` with the port's
  ``OnlineReranker``: slates within 1e-5 of the reference's, equal
  ``slate_reused``.
* ``diverse_rerank``: the reference's indices up to proven ties (where
  the picks part, both are equally far from the picks before them, rtol
  1e-5), and its ``DeprecationWarning``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as RM
from repro.models.common import ShardingRules as RefRules
from repro.serving import OnlineReranker as RefReranker
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.serving import diverse_rerank as ref_diverse_rerank
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference
from repro_torch.models.common import ShardingRules
from repro_torch.obs.trace import RunTrace, activate
from repro_torch.serving import (OnlineReranker, Request, ServingEngine,
                                 diverse_rerank)

REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None, act_heads=None)
RULES = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                      vocab=None, experts=None, fsdp=None, head_dim=None,
                      state=None, act_heads=None)
GAP = 4e-2          # twice the logits bound: below it a greedy pick may part
RTOL = 1e-5


@pytest.fixture(scope="module", params=["internlm2-1.8b", "gemma-2b"])
def models(request):
    arch = request.param
    rcfg = ref_configs.get_config(arch, reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = port_configs.get_config(arch, reduced=True)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _prompts(cfg, count, seed):
    """Ragged prompts of 3..10 token ids."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 11)))
            .astype(np.int32) for _ in range(count)]


def _reference_gaps(engine, requests):
    """Replay the reference engine's loop with its own jitted prefill and
    decode: the tokens (must equal its ``generate``'s) and every step's
    top-2 logit gap, a row a request."""
    toks_all, gaps_all = [], []
    for i in range(0, len(requests), engine.batch):
        group = requests[i:i + engine.batch]
        S = max(len(r.prompt) for r in group)
        toks = np.zeros((engine.batch, S), np.int32)
        for j, r in enumerate(group):
            toks[j, S - len(r.prompt):] = r.prompt
        cache = RM.make_cache(engine.cfg, engine.batch, engine.capacity)
        logits, cache = engine._prefill(engine.params,
                                        {"tokens": jnp.asarray(toks)}, cache)
        outs, gaps = [], []
        steps = max(r.max_new_tokens for r in group)
        for s in range(steps):
            last = np.asarray(logits[:, -1, :], np.float32)
            top2 = np.sort(last, axis=-1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None] \
                .astype(jnp.int32)
            outs.append(np.asarray(tok))
            if s < steps - 1:
                logits, cache = engine._decode(engine.params, tok,
                                               jnp.asarray(S + s), cache)
        outs, gaps = np.concatenate(outs, 1), np.stack(gaps, 1)
        for j, r in enumerate(group):
            toks_all.append(outs[j, :r.max_new_tokens])
            gaps_all.append(gaps[j, :r.max_new_tokens])
    return toks_all, gaps_all


@pytest.mark.parametrize("batch", [2, 4])
def test_generate_matches_reference_up_to_near_ties(models, batch):
    rcfg, params, cfg, model = models
    prompts = _prompts(cfg, 6, seed=batch)
    new = [12, 9, 12, 5, 12, 12]
    ref_engine = RefEngine(rcfg, REF_RULES, params, batch=batch, capacity=32)
    want = ref_engine.generate([RefRequest(prompt=p, max_new_tokens=n)
                                for p, n in zip(prompts, new)])
    replay, gaps = _reference_gaps(ref_engine, want)
    engine = ServingEngine(cfg, RULES, model, batch=batch, capacity=32)
    assert engine.device == torch.device("cpu")
    got = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in zip(prompts, new)])
    compared = total = 0
    for g, w, r, gap in zip(got, want, replay, gaps):
        np.testing.assert_array_equal(r, w.out)    # the replay is the engine
        assert g.out.dtype == w.out.dtype and g.out.shape == w.out.shape
        total += len(w.out)
        for s in range(len(w.out)):
            if g.out[s] != w.out[s]:
                assert gap[s] < GAP, (s, gap[s])
                break
            compared += 1
    print(f"compared {compared} of {total} greedy steps")
    assert compared >= total // 2


def test_generate_is_deterministic_and_spans(models):
    """Two runs give the same tokens; an enabled trace records one
    ``serving.generate`` a group with its prefill and decode spans."""
    _, _, cfg, model = models
    engine = ServingEngine(cfg, RULES, model, batch=2, capacity=24)
    prompts = _prompts(cfg, 3, seed=9)
    a = engine.generate([Request(prompt=p, max_new_tokens=6)
                         for p in prompts])
    tr = RunTrace(enabled=True)
    with activate(tr):
        b = engine.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.out, y.out)
    names = _span_names(tr.spans)
    assert names.count("serving.generate") == 2
    assert names.count("serving.prefill") == 2
    assert names.count("serving.decode") == 2 * 5


def _span_names(spans):
    return [n for sp in spans
            for n in [sp.name] + _span_names(sp.children)]


def test_capacity_too_short_raises(models):
    _, _, cfg, model = models
    engine = ServingEngine(cfg, RULES, model, batch=2, capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        engine.generate([Request(prompt=np.arange(1, 7, dtype=np.int32),
                                 max_new_tokens=4)])


def _with_candidates(requests, seed, n=40, d=8):
    rng = np.random.default_rng(seed)
    for i, r in enumerate(requests):
        r.candidates = (rng.normal(size=(n, d)) + i % 3).astype(np.float32)
    return requests


def _assert_slates(got, want):
    for g, w in zip(got, want):
        assert g.slate_reused == w.slate_reused
        np.testing.assert_allclose(g.slate, w.slate, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("measure", ["remote-edge", "remote-clique"])
def test_rerank_group_matches_reference(models, measure):
    """One group reranked twice: the second round re-serves the unchanged
    sessions from their certificates."""
    rcfg, params, cfg, model = models
    ref_engine = RefEngine(rcfg, REF_RULES, params, batch=4, capacity=32,
                           reranker=RefReranker(k=4, dim=8, kprime=12,
                                                measure=measure))
    engine = ServingEngine(cfg, RULES, model, batch=4, capacity=32,
                           reranker=OnlineReranker(k=4, dim=8, kprime=12,
                                                   measure=measure,
                                                   device="cpu"))
    for rnd in range(2):
        reqs = [[Request(prompt=np.ones(3, np.int32), session=f"s{i % 3}")
                 for i in range(4)] for _ in range(2)]
        want = ref_engine.rerank_group(_with_candidates(reqs[0], 5 + rnd))
        got = engine.rerank_group(_with_candidates(reqs[1], 5 + rnd))
        _assert_slates(got, want)
    assert engine.reranker.stats()["sessions_active"] == 3
    with pytest.raises(ValueError, match="reranker"):
        ServingEngine(cfg, RULES, model).rerank_group(got)


def test_generate_diverse_matches_reference(models):
    rcfg, params, cfg, model = models
    prompts = _prompts(cfg, 5, seed=11)
    ref_engine = RefEngine(rcfg, REF_RULES, params, batch=2, capacity=24,
                           reranker=RefReranker(k=3, dim=8, kprime=8))
    engine = ServingEngine(cfg, RULES, model, batch=2, capacity=24,
                           reranker=OnlineReranker(k=3, dim=8, kprime=8,
                                                   device="cpu"))
    want = ref_engine.generate_diverse(_with_candidates(
        [RefRequest(prompt=p, max_new_tokens=4) for p in prompts], 3))
    tr = RunTrace(enabled=True)
    with activate(tr):
        got = engine.generate_diverse(_with_candidates(
            [Request(prompt=p, max_new_tokens=4) for p in prompts], 3))
    _assert_slates(got, want)
    assert all(g.out is not None and len(g.out) == 4 for g in got)
    assert _span_names(tr.spans).count("serving.rerank_group") == 3


def _anticover(pts, idx, j):
    return float(np.linalg.norm(pts[idx[:j]] - pts[idx[j]], axis=1).min())


def _assert_picks(got, want, pts):
    """Equal picks, or equal up to the first proven near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for j in range(len(want)):
        if got[j] != want[j]:
            assert np.isclose(_anticover(pts, got, j),
                              _anticover(pts, want, j), rtol=RTOL), j
            return


@pytest.mark.parametrize("knobs", [{}, {"b": "auto"}, {"kprime": 24},
                                   {"b": 4, "kprime": 32}])
def test_diverse_rerank_matches_reference(knobs):
    emb = np.random.default_rng(4).normal(size=(300, 16)).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="diverse_rerank"):
        got = diverse_rerank(emb, 8, device="cpu", **knobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_diverse_rerank(emb, 8, **knobs)
    _assert_picks(got, want, emb)


@pytest.mark.parametrize("quotas", [None, [3, 2, 1]])
def test_diverse_rerank_with_labels_matches_reference(quotas):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(120, 16)).astype(np.float32)
    lab = rng.integers(0, 3, size=120)
    with pytest.warns(DeprecationWarning):
        got = diverse_rerank(emb, 6, group_labels=lab, quotas=quotas,
                             device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_diverse_rerank(emb, 6, group_labels=lab, quotas=quotas)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    want_counts = [2, 2, 2] if quotas is None else quotas
    assert np.bincount(lab[got], minlength=3).tolist() == want_counts


def test_diverse_rerank_follows_a_tensor_and_defaults_to_the_card(
        monkeypatch):
    emb = np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        idx = diverse_rerank(torch.as_tensor(emb), 5)     # a CPU tensor
    assert len(set(idx.tolist())) == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"), \
            pytest.warns(DeprecationWarning):
        diverse_rerank(emb, 5)


def test_engine_runs_where_the_model_is(monkeypatch):
    """The model (``init_params``) defaults to the card and raises without
    one; the engine takes the model's device."""
    cfg = port_configs.get_config("internlm2-1.8b", reduced=True)
    model = M.init_params(cfg, 0, device="cpu")
    assert ServingEngine(cfg, RULES, model).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(cfg, 0)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "gemma-2b", "--reduced", "--requests", "4",
                       "--new-tokens", "4", "--diverse-k", "2",
                       "--device", "cpu"])
    assert len(done) == 4 and all(len(r.out) == 4 for r in done)
    out = capsys.readouterr().out
    assert out.count("req ") == 4 and "most diverse 2" in out
