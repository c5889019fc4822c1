"""The port's hybrid family (``repro_torch.models.rglru``, recurrentgemma)
against the reference's (``repro.models.rglru``) on the CPU.

Module parity feeds the same seeded numpy inputs to both packages (the
reference's functions jitted, so its compiled graph's roundings hold):
``associative_scan`` against ``jax.lax.associative_scan`` on the RG-LRU
combine at odd and even lengths and at length 1 (equal in fp32),
``_rg_lru`` with and without ``h0``, its gradients where the clip
``maximum(1 - a², 1e-6)`` is active, ``_rec_sublayer`` without and with
a cache, and ``_attn_sublayer`` on a prompt longer than the window and
decode steps that wrap its rolling buffer.  fp32 is held within rtol
1e-5 (and an atol of 1e-5 of the largest entry: the packages sum in
other orders), bf16 within the reference's 2e-2.

Whole-model parity runs ``recurrentgemma-9b`` at ``reduced=True`` with
4 layers (1 leading recurrent layer and one group, every sublayer kind;
at the reduced 5 layers the random bf16 model is chaotic, see
``test_forward_logits_at_full_reduced_depth_within_the_floor``) on the
reference's own init carried by ``interop.params_from_reference``, at
the dense family's
bounds (``test_torch_models.py``, ``test_torch_train.py``): logits at
rtol = atol = 2e-2; the cache (K/V, slot positions, state and conv rows)
after a prefill longer than the window and after 3 decode steps at rtol
2e-2 and an atol of one bf16 ulp of the largest entry; the loss at rtol
1e-3; per-leaf bf16 gradients at relative Frobenius 0.15 and a quarter
of the reference's own bf16-vs-fp32 distance; the float64 gradient
against a central difference at rtol 1e-6; one AdamW step at the
reference's accumulation bound; the engine's tokens equal up to a
near-tie.  The
reference's loss and gradients are computed once for the module.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as RM
import repro.train as RT
from repro.data import lm_batch as ref_lm_batch
from repro.models import rglru as ref_rglru
from repro.models.common import ShardingRules as RefRules
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import rglru
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import AdamW, make_loss, make_train_step
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_map

ARCH = "recurrentgemma-9b"
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
FP32_RTOL = 1e-5
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
GAP = 4e-2
B, S = 2, 24                   # S beyond the reduced window of 16
# the whole-model tests' depth: 1 leading layer and 1 group, every
# sublayer kind (see test_forward_logits_at_full_reduced_depth_within_the_floor)
LAYERS = 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _close(got, want, dtype, err_msg=""):
    """fp32 within rtol 1e-5 and an atol of 1e-5 of the largest entry;
    bf16 within the reference's 2e-2."""
    want = _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=FP32_RTOL,
                                   atol=FP32_RTOL * float(np.abs(want).max()),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(_np(got), want, err_msg=err_msg, **TOL)


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(np.asarray(a)).to(tdt)


def _cfgs(dtype="bfloat16"):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_configs.get_config(ARCH, reduced=True)
    cfg = port_configs.get_config(ARCH, reduced=True)
    return (dataclasses.replace(rcfg, dtype=jdt, param_dtype=jdt),
            dataclasses.replace(cfg, dtype=tdt, param_dtype=tdt))


def _depth(n):
    """(reference cfg, port cfg) of the reduced config at ``n`` layers."""
    return (dataclasses.replace(ref_configs.get_config(ARCH, reduced=True),
                                num_layers=n),
            dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                num_layers=n))


def _lru_inputs(s, seed, r=24):
    """Seeded float32 inputs of ``_rg_lru``: x, gates_a, gates_i (2, s, r),
    lam (r,), h0 (2, r)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, r)).astype(np.float32),
            (2 * rng.normal(size=(2, s, r))).astype(np.float32),
            rng.normal(size=(2, s, r)).astype(np.float32),
            rng.normal(size=r).astype(np.float32),
            rng.normal(size=(2, r)).astype(np.float32)]


# -- module parity ---------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 8, 37])
def test_associative_scan_matches_jax(s):
    """The RG-LRU combine's inclusive scan along the sequence: the same
    combines in the same tree, so the fp32 results are equal."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, size=(2, s, 5)).astype(np.float32)
    b = rng.normal(size=(2, s, 5)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (a, b), axis=1))(
            jnp.asarray(a), jnp.asarray(b))
    got = rglru.associative_scan(rglru._lru_combine,
                                 (torch.as_tensor(a), torch.as_tensor(b)),
                                 dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_reference(with_h0, dtype):
    x, ga, gi, lam, h0 = _lru_inputs(19, seed=3)
    (rx, px), (ra, pa), (ri, pi), (rl, pl) = (_both(v, dtype)
                                              for v in (x, ga, gi, lam))
    want = jax.jit(ref_rglru._rg_lru)(rx, ra, ri, rl,
                                      jnp.asarray(h0) if with_h0 else None)
    got = rglru._rg_lru(px, pa, pi, pl,
                        torch.as_tensor(h0) if with_h0 else None)
    assert got[0].dtype == px.dtype and got[1].dtype == torch.float32
    for g, w, name in zip(got, want, ("y", "h_last")):
        _close(g, w, dtype, name)


def test_rg_lru_gradient_where_the_clip_is_active():
    """Strongly negative recurrence gates put a within 1e-6 of 1: the clip
    holds 1 - a² at 1e-6 and sends no gradient through it.  The port's
    fp32 gradients in every input equal the reference's (rtol 1e-5) and
    are finite."""
    x, ga, gi, lam, h0 = _lru_inputs(11, seed=4)
    ga[:, :, :8] = -30.0                     # sigmoid ~ 1e-13: a -> 1
    w = np.random.default_rng(5).normal(size=(2, 11, 24)).astype(np.float32)
    ins = (x, ga, gi, lam, h0)

    def ref_loss(*a):
        y, last = ref_rglru._rg_lru(*a)
        return (y * w).sum() + (last * last).sum()
    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, ins))
    ts = [torch.as_tensor(v).requires_grad_() for v in ins]
    y, last = rglru._rg_lru(*ts)
    got = torch.autograd.grad((y * torch.as_tensor(w)).sum()
                              + (last * last).sum(), ts)
    a_log = -8.0 * np.logaddexp(lam, 0) / (1 + np.exp(-ga))
    assert (1 - np.exp(2 * a_log) < 1e-6).sum() > 0
    for g, r, name in zip(got, want, ("x", "gates_a", "gates_i", "lam",
                                      "h0")):
        assert torch.isfinite(g).all(), name
        _close(g, r, "float32", name)


def _rec_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    D, R, F = cfg.d_model, cfg.rnn_width, cfg.d_ff
    return {"ln": rng.normal(size=D) * 0.1,
            "w_y": rng.normal(size=(D, R)) / np.sqrt(D),
            "w_x": rng.normal(size=(D, R)) / np.sqrt(D),
            "conv_w": rng.normal(size=(4, R)) / 2,
            "conv_b": rng.normal(size=R) * 0.1,
            "w_a": rng.normal(size=(R, R)) / np.sqrt(R),
            "w_i": rng.normal(size=(R, R)) / np.sqrt(R),
            "lam": 1 + 0.5 * rng.normal(size=R),
            "w_out": rng.normal(size=(R, D)) / np.sqrt(R),
            "ln2": rng.normal(size=D) * 0.1,
            "m_gate": rng.normal(size=(D, F)) / np.sqrt(D),
            "m_up": rng.normal(size=(D, F)) / np.sqrt(D),
            "m_down": rng.normal(size=(F, D)) / np.sqrt(F)}


def _attn_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    return {"ln": rng.normal(size=D) * 0.1,
            "wq": rng.normal(size=(D, H, hd)) / np.sqrt(D),
            "wk": rng.normal(size=(D, KV, hd)) / np.sqrt(D),
            "wv": rng.normal(size=(D, KV, hd)) / np.sqrt(D),
            "wo": rng.normal(size=(H, hd, D)) / np.sqrt(H * hd),
            "ln2": rng.normal(size=D) * 0.1,
            "m_gate": rng.normal(size=(D, F)) / np.sqrt(D),
            "m_up": rng.normal(size=(D, F)) / np.sqrt(D),
            "m_down": rng.normal(size=(F, D)) / np.sqrt(F)}


def _layer(weights, dtype):
    rlp, plp = {}, {}
    for k, v in weights.items():
        rlp[k], plp[k] = _both(np.asarray(v, np.float32), dtype)
    return rlp, types.SimpleNamespace(**plp)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["train", "cache"])
def test_rec_sublayer_matches_reference(mode, dtype):
    """Without a cache on 21 tokens; with one over 5 tokens from a random
    fp32 state and bf16 conv rows: the output, the new state and conv."""
    rcfg, cfg = _cfgs(dtype)
    rlp, plp = _layer(_rec_weights(cfg, 5), dtype)
    rng = np.random.default_rng(6)
    s = 21 if mode == "train" else 5
    rx, px = _both(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32),
                   dtype)
    if mode == "train":
        want, _ = jax.jit(lambda x, l: ref_rglru._rec_sublayer(
            x, l, rcfg, REF_RULES))(rx, rlp)
        got, _, row = rglru._rec_sublayer(px, plp, cfg, None)
        assert row is None and got.dtype == px.dtype
        _close(got, want, dtype)
        return
    st = rng.normal(size=(2, cfg.rnn_width)).astype(np.float32)
    cv = rng.normal(size=(2, 3, cfg.rnn_width)).astype(np.float32)
    rconv, pconv = _both(cv, "bfloat16")
    want, wrow = jax.jit(lambda x, l, r: ref_rglru._rec_sublayer(
        x, l, rcfg, REF_RULES, r))(rx, rlp, {"state": jnp.asarray(st),
                                              "conv": rconv})
    got, _, (gstate, gconv) = rglru._rec_sublayer(
        px, plp, cfg, None, (torch.as_tensor(st), pconv))
    assert gstate.dtype == torch.float32
    _close(got, want, dtype, "out")
    _close(gstate, wrow["state"], dtype, "state")
    _close(gconv, wrow["conv"], dtype, "conv")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attn_sublayer_rolling_window_matches_reference(dtype):
    """A prefill of 21 tokens past the window of 16 (the buffer keeps the
    last 16), then 4 decode steps that wrap it: each call's output and the
    buffer's K/V and slot positions after it."""
    rcfg, cfg = _cfgs(dtype)
    rlp, plp = _layer(_attn_weights(cfg, 7), dtype)
    rng = np.random.default_rng(8)
    W, KV, hd = cfg.window, cfg.num_kv_heads, cfg.head_dim
    pk = torch.zeros((2, W, KV, hd), dtype=DTYPES[dtype][1])
    pv, ppos = pk.clone(), torch.full((W,), -1, dtype=torch.int32)
    rrow = {"k": jnp.asarray(_np(pk), DTYPES[dtype][0]),
            "v": jnp.asarray(_np(pv), DTYPES[dtype][0]),
            "slot_pos": jnp.full((W,), -1, jnp.int32)}
    step = jax.jit(lambda x, l, p, r: ref_rglru._attn_sublayer(
        x, l, rcfg, REF_RULES, p, r))
    for p0, n in ((0, 21), (21, 1), (22, 1), (23, 1), (24, 1)):
        rx, px = _both(rng.normal(size=(2, n, cfg.d_model))
                       .astype(np.float32), dtype)
        pos = np.arange(p0, p0 + n, dtype=np.int32)
        want, rrow = step(rx, rlp, jnp.asarray(pos), rrow)
        got, _ = rglru._attn_sublayer(px, plp, cfg, None,
                                      torch.as_tensor(pos), (pk, pv, ppos))
        _close(got, want, dtype, f"out at {p0}")
        _close(pk, rrow["k"], dtype, f"k at {p0}")
        _close(pv, rrow["v"], dtype, f"v at {p0}")
        np.testing.assert_array_equal(ppos.numpy(),
                                      np.asarray(rrow["slot_pos"]))
    assert sorted(ppos.tolist()) == list(range(25 - W, 25))


# -- whole model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) of
    recurrentgemma reduced at ``LAYERS`` layers, on the reference's
    init."""
    rcfg, cfg = _depth(LAYERS)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _tokens(cfg, seed=2, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_layout_and_tree_follow_the_reference(pair):
    """2 leading layers and 1 group at 5 layers, 1 and 1 at 4, 2 and 12 at
    38; the port's tree has the reference's paths and shapes."""
    _, params, cfg, model = pair
    for n, want in ((5, (2, 1)), (4, (1, 1)), (38, (2, 12)), (3, (0, 1))):
        c = dataclasses.replace(cfg, num_layers=n)
        assert rglru._layout(c) == ref_rglru._layout(c) == want
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [(p, tuple(t.shape)) for p, t in tree_items(model)] == [
        (jax.tree_util.keystr(p), t.shape) for p, t in ref]


def test_forward_logits_match_reference(pair, ref_grads):
    """The logits of the module's batch (4 x 24 tokens) against the
    reference's, from the computation of its loss and gradients."""
    _, _, cfg, model = pair
    _, _, pb, want = ref_grads
    with torch.no_grad():
        got, cache = rglru.forward(model, cfg, None, pb["tokens"],
                                   torch.arange(S, dtype=torch.int32))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_forward_logits_at_full_reduced_depth_within_the_floor():
    """At the reduced config's own 5 layers (2 leading layers) the random
    model is chaotic in bf16: the packages' last-ulp differences (exp,
    log1p and tanh are other implementations) grow through the second
    leading layer (the reference's own jitted and eager forwards part by
    0.5-0.86 in the logits).  The port's logits are held within a quarter
    of the distance of the reference's bf16 logits from the port's fp32
    ones (the gradient tests' rule; read 0.016-0.13 against 0.30-0.39),
    and at 4 layers the same inputs agree within 2e-2 (read 1e-4)."""
    rcfg, cfg = _depth(5)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    toks = _tokens(cfg)
    want = np.asarray(jax.jit(lambda p, t: ref_rglru.forward(
        p, rcfg, REF_RULES, t, jnp.arange(S, dtype=jnp.int32))[0])(
            params, jnp.asarray(toks)))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    pos = torch.arange(S, dtype=torch.int32)
    with torch.no_grad():
        got = rglru.forward(model, cfg, None, torch.as_tensor(toks),
                            pos)[0].numpy()
        got32 = rglru.forward(tree_map(lambda w: w.float(), model), cfg32,
                              None, torch.as_tensor(toks), pos)[0].numpy()
    err, noise = np.abs(got - want).max(), np.abs(got32 - want).max()
    print(f"\nport vs reference {err:.3g}, reference bf16 vs port fp32 "
          f"{noise:.3g}")
    assert np.isfinite(got).all() and err <= GRAD_NOISE_SHARE * noise


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill S - 1 = 23 tokens (past the window), decode the S-th from
    the rolling buffer and the states: the last logits equal the full
    forward's."""
    _, _, cfg, model = pair
    toks = torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        full = rglru.forward(model, cfg, None, toks,
                             torch.arange(S, dtype=torch.int32))[0]
    cache = M.make_cache(cfg, B, 64, device="cpu")
    assert cache.kv.k.shape[2] == cfg.window
    _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks[:, :S - 1]},
                            cache)
    step, cache = M.decode_fn(model, cfg, None, toks[:, S - 1:], S - 1, cache)
    assert int(cache.pos) == S
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


ENGINE_B, ENGINE_S = 6, 20    # the engine tests' group: prompts up to 20


@pytest.fixture(scope="module")
def ref_engine(pair):
    """The reference's engine over ``pair``'s weights, its prefill and
    decode compiled once for the module's group shape (6 rows, prompts
    padded to 20, capacity 64)."""
    rcfg, params, _, _ = pair
    return RefEngine(rcfg, REF_RULES, params, batch=ENGINE_B, capacity=64)


def test_cache_matches_reference_after_prefill_and_decode(pair, ref_engine):
    """Prefill 20 tokens (the buffer keeps the last 16), then 3
    teacher-forced decode steps that wrap it, on both sides (the
    reference through its engine's jitted prefill and decode): every
    step's logits at the reference's bound, and K/V, states and conv rows
    after each phase (rtol 2e-2, atol one bf16 ulp of the largest entry),
    slot positions and ``pos`` exactly."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, seed=5, b=ENGINE_B, s=ENGINE_S + 3)
    S0 = ENGINE_S
    rc = RM.make_cache(rcfg, ENGINE_B, 64)
    pc = M.make_cache(cfg, ENGINE_B, 64, device="cpu")
    assert pc.state.dtype == torch.float32 and pc.conv.dtype == torch.bfloat16
    for got, want in ((pc.kv.k, rc.kv.k), (pc.state, rc.state),
                      (pc.conv, rc.conv), (pc.kv.slot_pos, rc.kv.slot_pos)):
        assert tuple(got.shape) == want.shape

    def caches_close(got, want):
        for name, g, w in (("k", got.kv.k, want.kv.k),
                           ("v", got.kv.v, want.kv.v),
                           ("state", got.state, want.state),
                           ("conv", got.conv, want.conv)):
            w = _np(w)
            np.testing.assert_allclose(_np(g), w, err_msg=name, rtol=2e-2,
                                       atol=2 ** -7 * float(np.abs(w).max()))
        np.testing.assert_array_equal(got.kv.slot_pos.numpy(),
                                      np.asarray(want.kv.slot_pos))
        assert int(got.pos) == int(want.pos)

    rl, rc = ref_engine._prefill(params, {"tokens": jnp.asarray(
        toks[:, :S0])}, rc)
    pl, pc = M.prefill_fn(model, cfg, None,
                          {"tokens": torch.as_tensor(toks[:, :S0])}, pc)
    np.testing.assert_allclose(pl.numpy(), _np(rl), **TOL)
    caches_close(pc, rc)
    for s in range(3):
        tok = toks[:, S0 + s:S0 + s + 1]
        rl, rc = ref_engine._decode(params, jnp.asarray(tok),
                                    jnp.asarray(S0 + s), rc)
        pl, pc = M.decode_fn(model, cfg, None, torch.as_tensor(tok), S0 + s,
                             pc)
        np.testing.assert_allclose(pl.numpy(), _np(rl), err_msg=f"step{s}",
                                   **TOL)
    caches_close(pc, rc)


def _batch(rcfg, seed=0, b=4, s=S):
    rb = ref_lm_batch(rcfg, seed=seed, step=0, batch=b, seq=s)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.fixture(scope="module")
def ref_grads(pair):
    """The reference's loss, bf16 gradients and logits on one batch (its
    ``loss_fn`` of the hybrid family: ``forward``, then ``_xent``),
    computed once for the module, with the batch."""
    rcfg, params, _, _ = pair
    rb, pb = _batch(rcfg)

    def loss(p, b):
        logits, _ = ref_rglru.forward(p, rcfg, REF_RULES, b["tokens"],
                                      jnp.arange(S, dtype=jnp.int32))
        return RM._xent(logits, b["labels"]), logits
    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, rb)
    return float(value), grads, pb, logits


def test_loss_and_gradients_match_reference(pair, ref_grads):
    """The loss at rtol 1e-3 and each leaf's bf16 gradient within relative
    Frobenius 0.15 and a quarter of the distance of the reference's bf16
    gradient from the port's fp32 one."""
    _, _, cfg, model = pair
    rloss, rg, pb, _ = ref_grads
    loss, pg = _value_and_grad(make_loss(cfg, None), model, pb)
    assert float(loss) == pytest.approx(rloss, rel=1e-3)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    _, g32 = _value_and_grad(make_loss(cfg32, None),
                             tree_map(lambda w: w.float(), model), pb)
    rows = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(rg)[0]:
        got = _leaf(pg, path)
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
        assert tuple(got.shape) == leaf.shape
        want = _np(leaf)
        rows.append((jax.tree_util.keystr(path), _fro(_np(got), want),
                     _fro(want, _np(_leaf(g32, path)))))
    print(f"\n{cfg.arch} per-leaf relative Frobenius error (port vs "
          "reference; reference bf16 vs fp32):",
          [f"{k} {e:.2e} {n:.2e}" for k, e, n in rows])
    for key, err, noise in rows:
        assert err <= GRAD_FRO, (key, err)
        assert err <= GRAD_NOISE_SHARE * noise, (key, err, noise)


def _fd_check(cfg, tree, pb, eps=1e-5):
    loss_fn = make_loss(cfg, None)
    loss, grads = _value_and_grad(loss_fn, tree, pb)
    assert loss.dtype == torch.float64
    gen = torch.Generator().manual_seed(2)
    d = tree_map(lambda w: torch.randn(w.shape, generator=gen,
                                       dtype=torch.float64), tree)
    norm = torch.sqrt(sum((x * x).sum() for x in tree_leaves(d)))
    d = tree_map(lambda x: x / norm, d)
    dot = float(sum((g * x).sum() for g, x in zip(tree_leaves(grads),
                                                  tree_leaves(d))))
    with torch.no_grad():
        lp = float(loss_fn(tree_map(lambda w, x: w + eps * x, tree, d), pb))
        lm = float(loss_fn(tree_map(lambda w, x: w - eps * x, tree, d), pb))
    return (lp - lm) / (2 * eps), dot


def test_float64_gradient_against_a_central_difference():
    """A float64 config runs in float64 end to end, the scan and the
    state included: autograd meets the float64 loss's central difference
    along a random unit direction to rtol 1e-6.  The step is 1e-7: the
    reference's init puts a third of the RG-LRU's entries inside the clip
    (1 - a² < 1e-6), and the loss curves hard near its kink (the
    difference's truncation error read 3.8e-3 on the embedding at step
    1e-5, 3.9e-7 at 1e-7)."""
    _, cfg = _depth(LAYERS)
    cfg = dataclasses.replace(cfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    tree = M.init_params(cfg, 0, device="cpu")
    _, pb = _batch(_depth(LAYERS)[0], seed=1)
    fd, dot = _fd_check(cfg, tree, pb, eps=1e-7)
    assert fd == pytest.approx(dot, rel=1e-6)


def test_remat_modes_give_equal_gradients():
    """``none``, ``dots`` and ``full`` give the same gradients bit for
    bit (each group under the checkpoint, the leading layers outside)."""
    rcfg, base = _depth(LAYERS)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(rcfg, seed=2)
    grads = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        xs = tree_map(lambda p: p.detach().requires_grad_(), tree)
        grads[mode] = torch.autograd.grad(M.loss_fn(xs, cfg, None, pb),
                                          tree_leaves(xs))
    for mode in ("dots", "full"):
        for a, b in zip(grads["none"], grads[mode]):
            assert torch.equal(a, b), mode


def test_adamw_train_step_matches_reference(pair, ref_grads):
    """One AdamW step from the same weights and batch: the port's
    ``make_train_step`` against the reference's update of its own
    gradients (the module's, what its ``make_train_step`` computes), the
    loss at rtol 2e-3 and the params at the reference's accumulation bound
    (rtol 2e-2, atol 2e-3)."""
    _, params, cfg, model = pair
    rloss, rg, pb, _ = ref_grads
    ropt, popt = RT.AdamW(), AdamW()
    rp, _ = jax.jit(lambda g, p: ropt.update(g, ropt.init(p), p, 1e-4))(
        rg, params)
    pstep = make_train_step(cfg, None, popt, lambda s: 1e-4)
    tree = tree_map(lambda t: t.clone(), model)
    tree, _, pm = pstep(tree, popt.init(tree), pb, 0)
    assert float(pm["loss"]) == pytest.approx(rloss, rel=2e-3)
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        np.testing.assert_allclose(_np(_leaf(tree, path)), _np(want),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))


# -- sizes, interop, engine, launchers ------------------------------------------------

def test_sizes_equal_reference_at_full_size():
    cfg, rcfg = port_configs.get_config(ARCH), ref_configs.get_config(ARCH)
    assert M.count_params(cfg) == RM.count_params(rcfg) == 9_396_195_328
    assert M.active_param_ratio(cfg) == RM.active_param_ratio(rcfg) == 1.0
    assert all(t.device.type == "meta"
               for t in tree_leaves(M.param_shapes(cfg)))
    c = M.make_cache(cfg, 8, 4096, shapes_only=True)
    r = RM.make_cache(rcfg, 8, 4096, shapes_only=True)
    assert [tuple(t.shape) for t in (*c.kv, c.state, c.conv, c.pos)] == \
        [t.shape for t in (*r.kv, r.state, r.conv, r.pos)]
    assert c.kv.k.shape[2] == 2048 and c.state.dtype == torch.float32
    assert all(t.device.type == "meta" for t in (*c.kv, c.state, c.conv))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_weights_round_trip_through_interop(pair, dtype):
    _, params, cfg, model = pair
    tree = params_to_reference(model, dtype=None if dtype is None
                               else jnp.bfloat16)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(_np(_leaf(tree, path)), _np(want))
    back = params_from_reference(tree, cfg, device="cpu")
    assert set(back) == {"embed", "final_norm", "groups", "lead"}
    assert set(back["groups"]) == {"attn", "rec_a", "rec_b"}
    for (n, a), (m, b) in zip(tree_items(model), tree_items(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


def _reference_gaps(engine, requests):
    """Replay the reference engine's loop with its jitted prefill and
    decode: its tokens and every step's top-2 logit gap, a row a
    request."""
    toks_all, gaps_all = [], []
    for i in range(0, len(requests), engine.batch):
        group = requests[i:i + engine.batch]
        S_ = max(len(r.prompt) for r in group)
        toks = np.zeros((engine.batch, S_), np.int32)
        for j, r in enumerate(group):
            toks[j, S_ - len(r.prompt):] = r.prompt
        cache = RM.make_cache(engine.cfg, engine.batch, engine.capacity)
        logits, cache = engine._prefill(engine.params,
                                        {"tokens": jnp.asarray(toks)}, cache)
        outs, gaps = [], []
        steps = max(r.max_new_tokens for r in group)
        for s in range(steps):
            top2 = np.sort(np.asarray(logits[:, -1, :], np.float32),
                           axis=-1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None] \
                .astype(jnp.int32)
            outs.append(np.asarray(tok))
            if s < steps - 1:
                logits, cache = engine._decode(engine.params, tok,
                                               jnp.asarray(S_ + s), cache)
        outs, gaps = np.concatenate(outs, 1), np.stack(gaps, 1)
        for j, r in enumerate(group):
            toks_all.append(outs[j, :r.max_new_tokens])
            gaps_all.append(gaps[j, :r.max_new_tokens])
    return toks_all, gaps_all


def test_engine_generates_as_the_reference_up_to_near_ties(pair,
                                                          ref_engine):
    """``ServingEngine.generate`` against the reference's engine, one group
    of 6 left-padded prompts of 14-20 tokens (the longest sets the group's
    20, past the window of 16) and up to 12 new ones, so prefill and
    decode both run past the rolling buffer.  The tokens are equal up to a near-tie
    (``test_torch_vlm.py``'s rule: where a row parts, the reference's
    top-2 logit gap there is under 4e-2), and at least half the steps
    are compared."""
    rcfg, params, cfg, model = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (ENGINE_S, *rng.integers(14, ENGINE_S + 1, 5))]
    new = [12, 9, 12, 5, 12, 12]
    want = ref_engine.generate([RefRequest(prompt=p, max_new_tokens=n)
                                for p, n in zip(prompts, new)])
    replay, gaps = _reference_gaps(ref_engine, want)
    got = ServingEngine(cfg, None, model, batch=ENGINE_B,
                        capacity=64).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    compared = 0
    for g, w, r, gap in zip(got, want, replay, gaps):
        np.testing.assert_array_equal(r, w.out)    # the replay is the engine
        assert g.out.dtype == w.out.dtype and g.out.shape == w.out.shape
        for s in range(len(w.out)):
            if g.out[s] != w.out[s]:
                assert gap[s] < GAP, (s, gap[s])
                break
            compared += 1
    print(f"\n{compared} of {sum(new)} steps compared")
    assert compared >= sum(new) // 2


def test_launchers_run_recurrentgemma_reduced_on_the_cpu(capsys):
    done = serve_launcher.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--requests", "3", "--new-tokens",
                                "4", "--diverse-k", "2"])
    out = capsys.readouterr().out.splitlines()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert out[-1].startswith("most diverse 2")
    train_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={ARCH}-reduced params=")
    assert [l.split()[1] for l in out[1:]] == ["0", "2"]
