"""The port's encoder-decoder family (``repro_torch.models.encdec``,
seamless-m4t) against the reference's (``repro.models.encdec``) on the
CPU.

Module parity feeds the same seeded numpy frames and tokens to both
packages (the reference's functions jitted): ``encode`` (non-causal
self-attention) and ``_decode_stack`` with the encoder's output (the
training path, cross K/V computed a layer) and through a cache (the
serving path, cross K/V read from it), fp32 within rtol 1e-5 (and an atol
of 1e-5 of the largest entry) and bf16 within the reference's 2e-2 (and
an atol of one bf16 ulp of the largest entry, see ``_close``).

Whole-model parity runs ``seamless-m4t-large-v2`` at ``reduced=True`` on
the reference's own init carried by ``interop.params_from_reference``, at
the dense family's bounds (``test_torch_models.py``,
``test_torch_train.py``): ``forward_train`` logits at rtol = atol = 2e-2;
prefill and decode against teacher forcing; the cache (self-attention
K/V and slot positions, the cross K/V cast to the cache's dtype,
``enc_pos``, ``pos``) after a prefill and after 3 decode steps; the loss
at rtol 1e-3; per-leaf bf16 gradients (the encoder's included: its
gradient reaches it through the cross-attention only) at relative
Frobenius 0.15 and a quarter of the reference's own bf16-vs-fp32
distance; the float64 gradient against a central difference; one AdamW
step; the engine's tokens equal with ``t_enc`` given and with
``t_enc=0`` (no frames: the reference's encoder raises on zero queries,
``0 % 0`` in ``attention._pick_chunk``; with that one guard patched into
it for the test, its tokens are the port's).  The reference's loss and
gradients are computed once for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as RM
import repro.models.attention as ref_attention
import repro.train as RT
from repro.data import lm_batch as ref_lm_batch
from repro.models import encdec as ref_encdec
from repro.models.common import ShardingRules as RefRules
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import encdec
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import AdamW, make_loss, make_train_step
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_map

ARCH = "seamless-m4t-large-v2"
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
FP32_RTOL = 1e-5
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
B, S, T = 2, 12, 10            # rows, decoder tokens, encoder frames
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
    bf16 within the reference's rtol 2e-2 and an atol of 2e-2 or one bf16
    ulp of the largest entry, whichever is larger (the stream reaches
    ~1e3 on the reference's init, where one ulp is 4-8; one decoder layer
    parts from the reference at 4 of 1,536 entries by one ulp)."""
    want = _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=FP32_RTOL,
                                   atol=FP32_RTOL * float(np.abs(want).max()),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(
            _np(got), want, rtol=TOL["rtol"], err_msg=err_msg,
            atol=max(TOL["atol"], 2 ** -7 * float(np.abs(want).max())))


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) of
    seamless reduced, on the reference's init."""
    rcfg = ref_configs.get_config(ARCH, reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = port_configs.get_config(ARCH, reduced=True)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _in_dtype(pair, dtype):
    """``pair``'s configs and weights in ``dtype``."""
    rcfg, params, cfg, model = pair
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(rcfg, dtype=jdt, param_dtype=jdt),
            jax.tree.map(lambda a: a.astype(jdt), params),
            dataclasses.replace(cfg, dtype=tdt, param_dtype=tdt),
            tree_map(lambda w: w.to(tdt), model))


def _frames(cfg, seed=3, b=B, t=T):
    return np.random.default_rng(seed).normal(
        size=(b, t, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed=2, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- module parity ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_reference(pair, dtype):
    rcfg, rp, cfg, pm = _in_dtype(pair, dtype)
    fr = _frames(cfg)
    want = jax.jit(lambda p, f: ref_encdec.encode(p, rcfg, REF_RULES, f))(
        rp, jnp.asarray(fr))
    with torch.no_grad():
        got = encdec.encode(pm, cfg, None, torch.as_tensor(fr))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["enc_out", "cache"])
def test_decode_stack_matches_reference(pair, mode, dtype):
    """The decoder over 12 tokens from an encoder output of 10 frames
    (seeded): the cross K/V computed a layer, or read from a cache that
    holds them (seeded, in the cache's bf16) with its self-attention
    rows written; the output and, through the cache, its new rows."""
    rcfg, rp, cfg, pm = _in_dtype(pair, dtype)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    if mode == "enc_out":
        enc = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
        want, _ = jax.jit(lambda p, x_, e: ref_encdec._decode_stack(
            p, rcfg, REF_RULES, x_, jnp.asarray(pos), enc_out=e))(
                rp, jnp.asarray(x, jdt), jnp.asarray(enc, jdt))
        with torch.no_grad():
            got, cache = encdec._decode_stack(
                pm, cfg, None, torch.as_tensor(x).to(tdt),
                torch.as_tensor(pos), enc_out=torch.as_tensor(enc).to(tdt))
        assert cache is None
        _close(got, want, dtype)
        return
    L = cfg.num_decoder_layers
    ck = rng.normal(size=(L, B, T, cfg.num_kv_heads, cfg.head_dim))
    cv = rng.normal(size=ck.shape)
    rc = RM.make_cache(rcfg, B, 16, t_enc=T)._replace(
        cross_k=jnp.asarray(ck, jnp.bfloat16),
        cross_v=jnp.asarray(cv, jnp.bfloat16))
    pc = encdec.init_cache(cfg, B, 16, T, dtype=torch.bfloat16,
                           device="cpu")._replace(
        cross_k=torch.as_tensor(ck).to(torch.bfloat16),
        cross_v=torch.as_tensor(cv).to(torch.bfloat16))
    want, wc = jax.jit(lambda p, x_, c: ref_encdec._decode_stack(
        p, rcfg, REF_RULES, x_, jnp.asarray(pos), cache=c))(
            rp, jnp.asarray(x, jdt), rc)
    with torch.no_grad():
        got, gc = encdec._decode_stack(pm, cfg, None,
                                       torch.as_tensor(x).to(tdt),
                                       torch.as_tensor(pos), cache=pc)
    _close(got, want, dtype, "out")
    _close(gc.self_kv.k, wc.self_kv.k, dtype, "k")
    _close(gc.self_kv.v, wc.self_kv.v, dtype, "v")
    np.testing.assert_array_equal(gc.self_kv.slot_pos.numpy(),
                                  np.asarray(wc.self_kv.slot_pos))
    assert int(gc.pos) == int(wc.pos) == S


# -- whole model -------------------------------------------------------------------

def test_forward_logits_match_reference(pair, ref_grads):
    """``forward_train``'s logits of the module's batch (4 rows of 10
    frames and 12 tokens) against the reference's, from the computation
    of its loss and gradients."""
    _, _, cfg, model = pair
    _, _, pb, want = ref_grads
    with torch.no_grad():
        got, none = encdec.forward_train(model, cfg, None, pb["frames"],
                                         pb["dec_tokens"])
    assert none is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill S - 1 tokens after encoding the frames, decode the S-th
    from the cache: the last logits equal ``forward_train``'s."""
    _, _, cfg, model = pair
    fr, toks = torch.as_tensor(_frames(cfg)), torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        full = encdec.forward_train(model, cfg, None, fr, toks)[0]
    cache = M.make_cache(cfg, B, S + 4, t_enc=T, device="cpu")
    _, cache = M.prefill_fn(model, cfg, None,
                            {"frames": fr, "dec_tokens": toks[:, :S - 1]},
                            cache)
    step, cache = M.decode_fn(model, cfg, None, toks[:, S - 1:], S - 1, cache)
    assert int(cache.pos) == S
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


ENGINE_B, ENGINE_S, ENGINE_T, ENGINE_C = 6, 10, 7, 24   # the engine's group


def _ref_engine(pair, t_enc):
    rcfg, params, _, _ = pair
    return RefEngine(rcfg, REF_RULES, params, batch=ENGINE_B,
                     capacity=ENGINE_C, t_enc=t_enc)


@pytest.fixture(scope="module")
def ref_engine(pair):
    """The reference's engine with ``ENGINE_T`` frames, its prefill and
    decode compiled once for the module's group shape."""
    return _ref_engine(pair, ENGINE_T)


def test_cache_matches_reference_after_prefill_and_decode(pair, ref_engine):
    """Prefill 10 tokens after 7 seeded frames, then 3 teacher-forced
    decode steps, on both sides (the reference through its engine's
    jitted prefill and decode): every call's logits at the reference's
    bound; self-attention K/V and the cross K/V (cast to the cache's
    bf16) at rtol 2e-2 and an atol of one bf16 ulp of the largest entry;
    slot positions, ``enc_pos`` and ``pos`` exactly."""
    rcfg, params, cfg, model = pair
    fr = _frames(cfg, seed=6, b=ENGINE_B, t=ENGINE_T)
    toks = _tokens(cfg, seed=5, b=ENGINE_B, s=ENGINE_S + 3)
    S0 = ENGINE_S
    rc = RM.make_cache(rcfg, ENGINE_B, ENGINE_C, t_enc=ENGINE_T)
    pc = M.make_cache(cfg, ENGINE_B, ENGINE_C, t_enc=ENGINE_T, device="cpu")
    assert [tuple(t.shape) for t in (*pc.self_kv, pc.cross_k, pc.cross_v,
                                     pc.enc_pos, pc.pos)] == \
        [t.shape for t in (*rc.self_kv, rc.cross_k, rc.cross_v, rc.enc_pos,
                           rc.pos)]

    def caches_close(got, want):
        for name, g, w in (("k", got.self_kv.k, want.self_kv.k),
                           ("v", got.self_kv.v, want.self_kv.v),
                           ("cross_k", got.cross_k, want.cross_k),
                           ("cross_v", got.cross_v, want.cross_v)):
            assert g.dtype == torch.bfloat16, name
            w = _np(w)
            np.testing.assert_allclose(_np(g), w, err_msg=name, rtol=2e-2,
                                       atol=2 ** -7 * float(np.abs(w).max()))
        np.testing.assert_array_equal(got.self_kv.slot_pos.numpy(),
                                      np.asarray(want.self_kv.slot_pos))
        np.testing.assert_array_equal(got.enc_pos.numpy(),
                                      np.asarray(want.enc_pos))
        assert int(got.pos) == int(want.pos)

    rl, rc = ref_engine._prefill(params, {
        "frames": jnp.asarray(fr), "dec_tokens": jnp.asarray(toks[:, :S0])},
        rc)
    pl, pc = M.prefill_fn(model, cfg, None,
                          {"frames": torch.as_tensor(fr),
                           "dec_tokens": torch.as_tensor(toks[:, :S0])}, pc)
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


def _batch(rcfg, seed=0, b=4, s=S, t_enc=T):
    rb = ref_lm_batch(rcfg, seed=seed, step=0, batch=b, seq=s, t_enc=t_enc)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.fixture(scope="module")
def ref_grads(pair):
    """The reference's loss, bf16 gradients and logits on one batch
    (frames and decoder tokens; its ``loss_fn`` of the encdec family:
    ``forward_train``, then ``_xent``), computed once for the module,
    with the batch."""
    rcfg, params, _, _ = pair
    rb, pb = _batch(rcfg)

    def loss(p, b):
        logits, _ = ref_encdec.forward_train(p, rcfg, REF_RULES, b["frames"],
                                             b["dec_tokens"])
        return RM._xent(logits, b["labels"]), logits
    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, rb)
    return float(value), grads, pb, logits


def test_loss_and_gradients_match_reference(pair, ref_grads):
    """The loss at rtol 1e-3 and each leaf's bf16 gradient within relative
    Frobenius 0.15 and a quarter of the distance of the reference's bf16
    gradient from the port's fp32 one; every encoder leaf's gradient is
    non-zero (it arrives through the cross-attention)."""
    _, _, cfg, model = pair
    rloss, rg, pb, _ = ref_grads
    assert set(pb) == {"frames", "dec_tokens", "labels"}
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
    assert all(float(g.float().abs().max()) > 0
               for g in tree_leaves(pg["encoder"]))


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
    """A float64 config runs in float64 end to end: autograd meets the
    float64 loss's central difference along a random unit direction of
    the whole tree (encoder and decoder) to rtol 1e-6 at step 1e-6 (the
    loss curves hard on the reference's init: the difference's truncation
    error read 4.9e-6 at step 1e-5 and 6.8e-8 at 1e-6)."""
    cfg = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                              dtype=torch.float64, param_dtype=torch.float64)
    tree = M.init_params(cfg, 0, device="cpu")
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=1)
    pb["frames"] = pb["frames"].double()
    fd, dot = _fd_check(cfg, tree, pb, eps=1e-6)
    assert fd == pytest.approx(dot, rel=1e-6)


def test_remat_modes_give_equal_gradients():
    """``none``, ``dots`` and ``full`` give the same gradients bit for
    bit (each encoder and decoder layer under the checkpoint)."""
    base = port_configs.get_config(ARCH, reduced=True)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=2)
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
    assert M.count_params(cfg) == RM.count_params(rcfg) == 1_772_480_512
    assert M.active_param_ratio(cfg) == RM.active_param_ratio(rcfg) == 1.0
    shapes = M.param_shapes(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert sum(t.numel() for t in tree_leaves(shapes["encoder"])) \
        == 704_692_224
    assert sum(t.numel() for t in tree_leaves(shapes["decoder"])) \
        == 805_380_096
    c = M.make_cache(cfg, 8, 96, t_enc=256, shapes_only=True)
    r = RM.make_cache(rcfg, 8, 96, t_enc=256, shapes_only=True)
    assert [tuple(t.shape) for t in (*c.self_kv, c.cross_k, c.cross_v,
                                     c.enc_pos, c.pos)] == \
        [t.shape for t in (*r.self_kv, r.cross_k, r.cross_v, r.enc_pos,
                           r.pos)]
    assert all(t.device.type == "meta" for t in (*c.self_kv, c.cross_k))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_weights_round_trip_through_interop(pair, dtype):
    _, params, cfg, model = pair
    tree = params_to_reference(model, dtype=None if dtype is None
                               else jnp.bfloat16)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(_np(_leaf(tree, path)), _np(want))
    back = params_from_reference(tree, cfg, device="cpu")
    assert set(back) == {"embed", "enc_norm", "final_norm", "encoder",
                         "decoder"}
    for (n, a), (m, b) in zip(tree_items(model), tree_items(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


def _prompts(cfg):
    """6 prompts of 3-10 tokens, the longest 10 (the group's S)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (ENGINE_S, *rng.integers(3, ENGINE_S + 1, 5))]
    return prompts, [8, 6, 8, 4, 8, 8]


def _guarded_pick_chunk(orig):
    def pick(sq, want):
        return 1 if sq == 0 else orig(sq, want)
    return pick


@pytest.mark.parametrize("t_enc", [ENGINE_T, 0])
def test_engine_generates_as_the_reference(pair, ref_engine, t_enc,
                                           monkeypatch):
    """``ServingEngine.generate`` of one group of 6 left-padded prompts
    with ``t_enc`` zero frames a row, and
    with ``t_enc=0`` (the reference engine's default: no frames, the
    cache made for S, the cross-attention over no keys adds nothing):
    the tokens equal the reference engine's.  With ``t_enc=0`` the
    reference raises ``ZeroDivisionError`` (its encoder's attention picks
    a chunk of 0 queries); the comparison runs it with that guard
    patched in."""
    rcfg, params, cfg, model = pair
    prompts, new = _prompts(cfg)

    def ref_run():
        engine = ref_engine if t_enc == ENGINE_T else _ref_engine(pair,
                                                                  t_enc)
        return engine.generate([RefRequest(prompt=p, max_new_tokens=n)
                                for p, n in zip(prompts, new)])
    if t_enc == 0:
        with pytest.raises(ZeroDivisionError):
            ref_run()
        monkeypatch.setattr(ref_attention, "_pick_chunk",
                            _guarded_pick_chunk(ref_attention._pick_chunk))
    want = ref_run()
    got = ServingEngine(cfg, None, model, batch=ENGINE_B, capacity=ENGINE_C,
                        t_enc=t_enc).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    for g, w in zip(got, want):
        assert g.out.dtype == w.out.dtype
        np.testing.assert_array_equal(g.out, w.out)


def test_launchers_run_seamless_reduced_on_the_cpu(capsys):
    """The serving launcher through the engine's ``t_enc=0`` path (as the
    reference's launcher builds its engine), the training launcher on
    ``lm_batch``'s frames (``--seq // 2`` of them) and tokens."""
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
