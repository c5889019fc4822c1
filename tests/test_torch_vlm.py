"""The port's vlm family (``repro_torch.models.vlm``, phi-3-vision) against
the reference's (``repro.models.vlm``) on the CPU.

``phi-3-vision-4.2b`` at ``reduced=True`` on the reference's own init
carried by ``interop.params_from_reference``, with seeded numpy patch
embeddings, at the dense family's bounds (``test_torch_models.py``,
``test_torch_train.py``): logits at rtol = atol = 2e-2; K/V after a
prefill of the patches and the prompt and after 3 decode steps (the
decode position counting the patches) at rtol 2e-2 and an atol of one
bf16 ulp of the largest entry, slot positions exactly, and those calls'
logits with the atol raised to that ulp where it is larger
(``_logits_close``); the loss over the
text positions at rtol 1e-3; per-leaf bf16 gradients (``patch_proj``'s
included) at relative Frobenius 0.15 and a quarter of the reference's own
bf16-vs-fp32 distance; the float64 gradient against a central difference
at rtol 1e-6; one AdamW step at the reference's accumulation bound; the
engine's tokens equal up to a near-tie (``test_torch_serving_engine.py``'s
rule: where a row parts, the reference's top-2 logit gap is under 4e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as RM
import repro.train as RT
from repro.data import lm_batch as ref_lm_batch
from repro.models import vlm as ref_vlm
from repro.models.common import ShardingRules as RefRules
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.data import lm_batch
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer, vlm
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import (AdamW, default_optimizer, make_loss,
                               make_train_step)
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_map

ARCH = "phi-3-vision-4.2b"
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
GAP = 4e-2
B, S = 2, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fro(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) of
    phi-3-vision reduced, on the reference's init."""
    rcfg = ref_configs.get_config(ARCH, reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = port_configs.get_config(ARCH, reduced=True)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _inputs(cfg, seed=2, b=B, s=S):
    """Seeded token ids (b, s) and patch embeddings (b, P, D_VISION)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.normal(size=(b, cfg.num_patches, vlm.D_VISION))
            .astype(np.float32))


def test_inputs_embeds_start_the_transformer_stream():
    """A dense model fed its own table rows through ``inputs_embeds``
    computes what it computes from the tokens, bit for bit."""
    cfg = port_configs.get_config("internlm2-1.8b", reduced=True)
    model = M.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(_inputs(cfg)[0])
    pos = torch.arange(S, dtype=torch.int32)
    with torch.no_grad():
        want = transformer.forward(model, cfg, None, toks, pos)[0]
        x = model["embed"][toks.long()].float()
        got = transformer.forward(model, cfg, None, toks, pos,
                                  inputs_embeds=x)[0]
    assert torch.equal(got, want)


def test_forward_logits_match_reference(pair):
    rcfg, params, cfg, model = pair
    toks, pe = _inputs(cfg)
    want = jax.jit(lambda p, t, e: ref_vlm.forward_train(
        p, rcfg, REF_RULES, t, e)[0])(params, jnp.asarray(toks),
                                      jnp.asarray(pe))
    with torch.no_grad():
        got, cache = vlm.forward_train(model, cfg, None, torch.as_tensor(toks),
                                       torch.as_tensor(pe))
    assert cache is None and got.dtype == torch.float32
    assert tuple(got.shape) == (B, cfg.num_patches + S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill the patches and S-1 tokens, decode the S-th at position
    P + S - 1: the last logits equal the full forward's."""
    _, _, cfg, model = pair
    toks, pe = (torch.as_tensor(a) for a in _inputs(cfg))
    with torch.no_grad():
        full = vlm.forward_train(model, cfg, None, toks, pe)[0]
    P = cfg.num_patches
    cache = M.make_cache(cfg, B, P + S + 8, device="cpu")
    _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks[:, :S - 1],
                                               "patch_embeds": pe}, cache)
    step, _ = M.decode_fn(model, cfg, None, toks[:, S - 1:], P + S - 1,
                          cache)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


def _logits_close(got, want, err_msg=""):
    """Logits of a cached call: rtol 2e-2 and an atol of 2e-2 or one bf16
    ulp of the largest entry, the larger.  The logits are bf16 products
    upcast, and the two packages' exp, rsqrt, sin and cos part at fp32's
    last bit on 5-36 % of their inputs (measured on the CPU), so a bf16
    rounding of the stream flips now and then; with the patches'
    N(0, 1) rows in the stream such a flip reached 0.030 at a logit of
    0.07 (the reference's prefill, seed 5), one ulp of the largest."""
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=2e-2, err_msg=err_msg,
        atol=max(2e-2, 2 ** -7 * float(np.abs(want).max())))


def test_cache_matches_reference_after_prefill_and_decode(pair):
    rcfg, params, cfg, model = pair
    toks, pe = _inputs(cfg, seed=5)
    P, S0, cap = cfg.num_patches, S - 3, cfg.num_patches + S + 8
    rc = RM.make_cache(rcfg, B, cap)
    pc = M.make_cache(cfg, B, cap, device="cpu")

    def caches_close(got, want):
        for f in ("k", "v"):
            w = _np(getattr(want, f))
            np.testing.assert_allclose(_np(getattr(got, f)), w, err_msg=f,
                                       rtol=2e-2,
                                       atol=2 ** -7 * float(np.abs(w).max()))
        np.testing.assert_array_equal(got.slot_pos.numpy(),
                                      np.asarray(want.slot_pos))

    rl, rc = jax.jit(lambda p, t, e, c: ref_vlm.prefill(
        p, rcfg, REF_RULES, t, e, c))(params, jnp.asarray(toks[:, :S0]),
                                      jnp.asarray(pe), rc)
    pl, pc = vlm.prefill(model, cfg, None, torch.as_tensor(toks[:, :S0]),
                         torch.as_tensor(pe), pc)
    _logits_close(pl, rl)
    caches_close(pc, rc)
    decode = jax.jit(lambda p, t, pos, c: ref_vlm.decode_step(
        p, rcfg, REF_RULES, t, pos, c))
    for s in range(3):
        tok = toks[:, S0 + s:S0 + s + 1]
        rl, rc = decode(params, jnp.asarray(tok), jnp.asarray(P + S0 + s), rc)
        pl, pc = vlm.decode_step(model, cfg, None, torch.as_tensor(tok),
                                 P + S0 + s, pc)
        _logits_close(pl, rl, err_msg=f"step{s}")
    caches_close(pc, rc)


def _batch(rcfg, seed=0, b=4, s=16):
    rb = ref_lm_batch(rcfg, seed=seed, step=0, batch=b, seq=s)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_lm_batch_equals_reference(pair):
    rcfg, _, cfg, _ = pair
    rb = ref_lm_batch(rcfg, seed=3, step=1, batch=2, seq=8)
    pb = lm_batch(cfg, seed=3, step=1, batch=2, seq=8, device="cpu")
    assert sorted(pb) == sorted(rb) == ["labels", "patch_embeds", "tokens"]
    for k in rb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]))
    assert pb["patch_embeds"].shape[-1] == vlm.D_VISION == ref_vlm.D_VISION


def test_loss_and_gradients_match_reference(pair):
    """The loss over the text positions at rtol 1e-3, and each leaf's bf16
    gradient within relative Frobenius 0.15 and a quarter of the distance
    of the reference's bf16 gradient from the port's fp32 one."""
    rcfg, params, cfg, model = pair
    rb, pb = _batch(rcfg)
    rloss, rg = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, REF_RULES, b)))(params, rb)
    loss, pg = _value_and_grad(make_loss(cfg, None), model, pb)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-3)
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
    assert "['patch_proj']" in [k for k, *_ in rows]
    for key, err, noise in rows:
        assert err <= GRAD_FRO, (key, err)
        assert err <= GRAD_NOISE_SHARE * noise, (key, err, noise)


def test_loss_reads_the_text_positions_only(pair):
    """The labels are the tokens': the loss is the text positions'
    cross-entropy, the patches' logits left out."""
    _, _, cfg, model = pair
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=4)
    with torch.no_grad():
        logits = vlm.forward_train(model, cfg, None, pb["tokens"],
                                   pb["patch_embeds"])[0]
        want = M._xent(logits[:, cfg.num_patches:], pb["labels"])
        assert float(M.loss_fn(model, cfg, None, pb)) == float(want)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_float64_gradient_against_a_central_difference(remat):
    cfg = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                              dtype=torch.float64, param_dtype=torch.float64,
                              remat=remat)
    tree = tree_map(lambda w: w.double(), M.init_params(cfg, 0, device="cpu"))
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=1, b=2,
                   s=8)
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
    eps = 1e-5
    with torch.no_grad():
        lp = float(loss_fn(tree_map(lambda w, x: w + eps * x, tree, d), pb))
        lm = float(loss_fn(tree_map(lambda w, x: w - eps * x, tree, d), pb))
    assert (lp - lm) / (2 * eps) == pytest.approx(dot, rel=1e-6)


def test_remat_modes_give_equal_gradients():
    base = port_configs.get_config(ARCH, reduced=True)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=2, b=2,
                   s=8)
    grads = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        xs = tree_map(lambda p: p.detach().requires_grad_(), tree)
        grads[mode] = torch.autograd.grad(M.loss_fn(xs, cfg, None, pb),
                                          tree_leaves(xs))
    for mode in ("dots", "full"):
        for a, b in zip(grads["none"], grads[mode]):
            assert torch.equal(a, b), mode


def test_adamw_train_step_matches_reference(pair):
    rcfg, params, cfg, model = pair
    rb, pb = _batch(rcfg, seed=3, b=2, s=8)
    ropt, popt = RT.AdamW(), AdamW()
    rstep = jax.jit(RT.make_train_step(rcfg, REF_RULES, ropt,
                                       lambda s: 1e-4))
    pstep = make_train_step(cfg, None, popt, lambda s: 1e-4)
    tree = tree_map(lambda t: t.clone(), model)
    rp, _, rm = rstep(params, ropt.init(params), rb, 0)
    tree, _, pm = pstep(tree, popt.init(tree), pb, 0)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=2e-3)
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        np.testing.assert_allclose(_np(_leaf(tree, path)), _np(want),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))


# -- sizes, interop, engine, launchers ----------------------------------------------

def test_sizes_equal_reference_at_full_size():
    cfg, rcfg = port_configs.get_config(ARCH), ref_configs.get_config(ARCH)
    assert M.count_params(cfg) == RM.count_params(rcfg) == 3_824_225_280
    assert M.active_param_ratio(cfg) == RM.active_param_ratio(rcfg) == 1.0
    shapes = M.param_shapes(cfg)
    assert tuple(shapes["patch_proj"].shape) == (vlm.D_VISION, 3072)
    ref = jax.tree_util.tree_flatten_with_path(RM.param_shapes(rcfg))[0]
    assert [(p, tuple(t.shape)) for p, t in tree_items(shapes)] == [
        (jax.tree_util.keystr(p), s.shape) for p, s in ref]
    assert type(default_optimizer(cfg)).__name__ == \
        type(RT.default_optimizer(rcfg)).__name__ == "AdamW"


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_weights_round_trip_through_interop(pair, dtype):
    _, params, cfg, model = pair
    tree = params_to_reference(model, dtype=None if dtype is None
                               else jnp.bfloat16)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(_np(_leaf(tree, path)), _np(want))
    back = params_from_reference(tree, cfg, device="cpu")
    for (n, a), (m, b) in zip(tree_items(model), tree_items(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


def _reference_gaps(engine, requests, P):
    """Replay the reference engine's loop with its jitted prefill and
    decode (zero patch embeddings, decode positions after the patches):
    its tokens and every step's top-2 logit gap, a row a request."""
    toks_all, gaps_all = [], []
    for i in range(0, len(requests), engine.batch):
        group = requests[i:i + engine.batch]
        S_ = max(len(r.prompt) for r in group)
        toks = np.zeros((engine.batch, S_), np.int32)
        for j, r in enumerate(group):
            toks[j, S_ - len(r.prompt):] = r.prompt
        cache = RM.make_cache(engine.cfg, engine.batch, engine.capacity)
        logits, cache = engine._prefill(
            engine.params, {"tokens": jnp.asarray(toks), "patch_embeds":
                            jnp.zeros((engine.batch, P, ref_vlm.D_VISION))},
            cache)
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
                                               jnp.asarray(P + S_ + s), cache)
        outs, gaps = np.concatenate(outs, 1), np.stack(gaps, 1)
        for j, r in enumerate(group):
            toks_all.append(outs[j, :r.max_new_tokens])
            gaps_all.append(gaps[j, :r.max_new_tokens])
    return toks_all, gaps_all


def test_engine_generates_as_the_reference_up_to_near_ties(pair):
    rcfg, params, cfg, model = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 11)))
               .astype(np.int32) for _ in range(6)]
    new = [12, 9, 12, 5, 12, 12]
    ref_engine = RefEngine(rcfg, REF_RULES, params, batch=4, capacity=40)
    want = ref_engine.generate([RefRequest(prompt=p, max_new_tokens=n)
                                for p, n in zip(prompts, new)])
    replay, gaps = _reference_gaps(ref_engine, want, cfg.num_patches)
    got = ServingEngine(cfg, None, model, batch=4, capacity=40).generate(
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


def test_engine_capacity_counts_the_patches(pair):
    _, _, cfg, model = pair
    P = cfg.num_patches
    engine = ServingEngine(cfg, None, model, batch=2, capacity=P + 8)
    reqs = [Request(prompt=np.arange(1, 6, dtype=np.int32),
                    max_new_tokens=4)]
    assert len(engine.generate(reqs)[0].out) == 4      # P + 5 + 3 slots
    reqs[0].max_new_tokens = 5
    with pytest.raises(ValueError, match=f"{P} patch"):
        engine.generate(reqs)


def test_launchers_run_phi3_vision_reduced_on_the_cpu(capsys):
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
