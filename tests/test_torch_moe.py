"""The port's MoE family (``repro_torch.models.moe`` and the transformer's
expert branch) against the reference's (``repro.models.moe``) on the CPU.

Module parity feeds the same seeded numpy inputs to both packages:

* ``_dispatch_local`` at the full expert range and at two partial ranges:
  ``keep``, ``dest_e``, ``dest_c``, the capacity and the buffer exactly
  equal, the gates within the dtype's bound;
* ``_combine_local``, ``_expert_ffn``, ``_moe_mlp_gspmd`` and
  ``moe_aux_loss``: fp32 within rtol 1e-6 (and an atol of 1e-6 of the
  largest entry: the two packages sum in different orders), bf16 within
  the reference's 2e-2;
* with drops (capacity factor 0.5) and at a decode-sized N.

Whole-model parity runs ``granite-moe-1b-a400m`` and ``arctic-480b`` (its
dense-residual branch) at ``reduced=True`` on the reference's own init
carried by ``interop.params_from_reference``, at the dense family's bounds
(``test_torch_models.py``, ``test_torch_train.py``).  Routing is compared
layer by layer: each package's router logits are recorded (the port's by
wrapping ``moe._dispatch_local``, the reference's by a ``jax.debug``
callback on ``lax.top_k``'s operand inside its compiled scan), and a token
whose top-k expert set differs between them must be a proven near-tie: the
gap between its k-th and (k+1)-th logit on each side is no larger than the
largest logit difference between the packages on the tokens that agree.
The logits are then compared at the positions no near-tie reaches (in a
row, from the first near-tie on: attention carries it forward).
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
import repro.models as RM
import repro.train as RT
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.models.common import ShardingRules as RefRules
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe, transformer
from repro_torch.train import (AdamW, default_optimizer, make_loss,
                               make_train_step)
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_map

ARCHS = ["granite-moe-1b-a400m", "arctic-480b"]
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
FP32_RTOL = 1e-6
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
B, S = 2, 24


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fro(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close32(got, want, err_msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=FP32_RTOL,
                               atol=FP32_RTOL * float(np.abs(want).max()),
                               err_msg=err_msg)


# -- module parity -------------------------------------------------------------

# (arch, capacity factor, tokens): the reduced configs' own factor (4.0, no
# drops), 0.5 (about half the assignments dropped) and a decode-sized call
CASES = [("granite-moe-1b-a400m", None, 48),
         ("granite-moe-1b-a400m", 0.5, 48),
         ("granite-moe-1b-a400m", 1.25, 3),
         ("arctic-480b", 0.5, 40)]
CASE_IDS = [f"{a[:6]}-cf{cf}-N{n}" for a, cf, n in CASES]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, cf, dtype="bfloat16"):
    """(reference cfg, port cfg) of the reduced arch, with the capacity
    factor ``cf`` (None: the config's) and activations in ``dtype``."""
    rcfg = ref_configs.get_config(arch, reduced=True)
    cfg = port_configs.get_config(arch, reduced=True)
    cf = rcfg.capacity_factor if cf is None else cf
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(rcfg, capacity_factor=cf, dtype=jdt,
                                param_dtype=jdt),
            dataclasses.replace(cfg, capacity_factor=cf, dtype=tdt,
                                param_dtype=tdt))


def _layer(cfg, N, seed):
    """Seeded float32 inputs of one MoE layer: tokens (N, D), router logits
    (N, E), router (D, E), experts' gate/up (E, D, F) and down (E, F, D)."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"x": rng.normal(size=(N, D)).astype(np.float32),
            "logits": rng.normal(size=(N, E)).astype(np.float32),
            "router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
            "w_down": w(E, F, D)}


def _both(a, dtype):
    """``a`` as the reference's and the port's array in ``dtype`` (both
    round the same float32 values to nearest-even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


def _ranges(E):
    return {"full": (0, E), "low": (0, E // 2), "high": (E // 2, E - E // 2)}


@pytest.mark.parametrize("rng_name", ["full", "low", "high"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_dispatch_local_equals_reference(case, rng_name):
    arch, cf, N = case
    rcfg, cfg = _cfgs(arch, cf)
    inp = _layer(cfg, N, seed=N)
    E_range = _ranges(cfg.num_experts)[rng_name]
    jx, tx = _both(inp["x"], "bfloat16")
    rbuf, (rkeep, rde, rdc, rgates, rC) = ref_moe._dispatch_local(
        jx, jnp.asarray(inp["logits"]), E_range, rcfg)
    buf, (keep, de, dc, gates, C) = moe._dispatch_local(
        tx, torch.as_tensor(inp["logits"]), E_range, cfg)
    assert C == rC == moe.capacity(cfg, N)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(de.numpy(), np.asarray(rde))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(rdc))
    assert buf.dtype == torch.bfloat16 and tuple(buf.shape) == rbuf.shape
    np.testing.assert_array_equal(buf.view(torch.int16).numpy(),
                                  np.asarray(rbuf).view(np.int16))
    np.testing.assert_allclose(_np(gates), _np(rgates), **TOL)
    if cf == 0.5 and rng_name == "full":
        assert 0 < int((~keep).sum()) < keep.numel()       # drops happen


def _meta_of(cfg, inp, E_range, dtype):
    _, tx = _both(inp["x"], dtype)
    return moe._dispatch_local(tx, torch.as_tensor(inp["logits"]), E_range,
                               cfg)


def _ref_meta(meta):
    keep, de, dc, gates, C = meta
    jdt = jnp.bfloat16 if gates.dtype == torch.bfloat16 else jnp.float32
    return (jnp.asarray(keep.numpy()), jnp.asarray(de.numpy()),
            jnp.asarray(dc.numpy()), jnp.asarray(_np(gates), jdt), C)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_combine_and_expert_ffn_match_reference(case, dtype):
    """The experts' GLU on the dispatched buffer, then the combine, each
    from the same inputs on both sides."""
    arch, cf, N = case
    rcfg, cfg = _cfgs(arch, cf, dtype)
    inp = _layer(cfg, N, seed=N + 1)
    buf, meta = _meta_of(cfg, inp, (0, cfg.num_experts), dtype)
    ws = {k: _both(inp[k], dtype) for k in ("w_gate", "w_up", "w_down")}
    rbuf = jnp.asarray(_np(buf), DTYPES[dtype][0])
    ry = ref_moe._expert_ffn(rbuf, *(ws[k][0] for k in ws), rcfg)
    y = moe._expert_ffn(buf, *(ws[k][1] for k in ws), cfg)
    assert y.dtype == DTYPES[dtype][1]
    D, topk = cfg.d_model, cfg.num_experts_per_tok
    # the combine of one output (the port's), so the two combines see the
    # same rows
    ry_same = jnp.asarray(_np(y), DTYPES[dtype][0])
    rout = ref_moe._combine_local(ry_same, _ref_meta(meta), N, topk, D)
    out = moe._combine_local(y, meta, N, topk, D)
    assert out.dtype == DTYPES[dtype][1] and tuple(out.shape) == (N, D)
    if dtype == "float32":
        _close32(y, ry, "expert_ffn")
        _close32(out, rout, "combine")
    else:
        np.testing.assert_allclose(_np(y), _np(ry), **TOL)
        np.testing.assert_allclose(_np(out), _np(rout), **TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_moe_mlp_matches_reference(case, dtype):
    """The whole layer from (B, S, D) activations: router, dispatch,
    experts and combine."""
    arch, cf, N = case
    rcfg, cfg = _cfgs(arch, cf, dtype)
    inp = _layer(cfg, N, seed=N + 2)
    jx, tx = _both(inp["x"].reshape(1, N, -1), dtype)
    ws = {k: _both(inp[k], dtype) for k in ("w_gate", "w_up", "w_down")}
    rr = jnp.asarray(inp["router"])
    want = ref_moe._moe_mlp_gspmd(jx, rr, *(ws[k][0] for k in ws), rcfg,
                                  REF_RULES)
    got = moe.moe_mlp(tx, torch.as_tensor(inp["router"]),
                      *(ws[k][1] for k in ws), cfg, None)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    if dtype == "float32":
        _close32(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_partial_expert_ranges_sum_to_the_whole_layer():
    """What the reference's shard_map ``psum`` relies on: the layer over
    the expert ranges [0, E/2) and [E/2, E), each with its own dispatch,
    experts and combine, sums to the layer over all experts, drops
    included (an expert's ranks count its own assignments only)."""
    _, cfg = _cfgs("arctic-480b", 0.5, "float32")
    N, E, topk, D = 40, cfg.num_experts, cfg.num_experts_per_tok, \
        cfg.d_model
    inp = _layer(cfg, N, seed=7)
    x = torch.as_tensor(inp["x"])
    logits = x @ torch.as_tensor(inp["router"])
    ws = [torch.as_tensor(inp[k]) for k in ("w_gate", "w_up", "w_down")]
    whole = moe.moe_mlp(x[None], torch.as_tensor(inp["router"]), *ws, cfg,
                        None)[0]
    parts = []
    for name in ("low", "high"):
        e0, el = _ranges(E)[name]
        buf, meta = moe._dispatch_local(x, logits, (e0, el), cfg)
        y = moe._expert_ffn(buf, *(w[e0:e0 + el] for w in ws), cfg)
        parts.append(moe._combine_local(y, meta, N, topk, D))
    assert int((~moe._dispatch_local(x, logits, (0, E), cfg)[1][0]).sum()) \
        > 0
    _close32(parts[0] + parts[1], whole)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_aux_loss_matches_reference(dtype):
    rcfg, cfg = _cfgs("arctic-480b", None, dtype)
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(64, cfg.num_experts)).astype(np.float32) * 2
    jl, tl = _both(logits, dtype)
    _, top_i = jax.lax.top_k(jl.astype(jnp.float32), 2)
    want = ref_moe.moe_aux_loss(jl, top_i, rcfg)
    got = moe.moe_aux_loss(tl, torch.as_tensor(np.asarray(top_i)), cfg)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=FP32_RTOL)


# -- routing, recorded on both sides -------------------------------------------

def _port_logits(fn, monkeypatch):
    """(``fn()``, the router logits of every MoE layer it ran)."""
    seen, real = [], moe._dispatch_local

    def record(xf, logits, E_range, cfg):
        seen.append(logits.detach().float().numpy().copy())
        return real(xf, logits, E_range, cfg)
    monkeypatch.setattr(moe, "_dispatch_local", record)
    out = fn()
    monkeypatch.setattr(moe, "_dispatch_local", real)
    return out, seen


def _ref_logits(fn, monkeypatch):
    """(``fn()`` traced afresh, the router logits of every MoE layer it
    ran): ``lax.top_k``'s operand handed to a host callback, in order."""
    seen, real = [], jax.lax.top_k

    def top_k(x, k):
        jax.debug.callback(lambda v: seen.append(np.asarray(v, np.float32)),
                           x, ordered=True)
        return real(x, k)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    out = jax.block_until_ready(fn())
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", real)
    return out, seen


def _topk_sets(logits, k):
    return np.sort(np.argsort(-logits, axis=1, kind="stable")[:, :k], axis=1)


def _gap(logits, k):
    s = -np.sort(-logits, axis=1)
    return s[:, k - 1] - s[:, k]


def _near_ties(port, ref, k):
    """[(layer, token)] where the two packages' top-k expert sets differ,
    each proven a near-tie (asserted): on both sides the gap between the
    k-th and (k+1)-th logit is no larger than the largest logit difference
    between the packages over the tokens that agree."""
    assert len(port) == len(ref) and len(port) > 0
    ties = []
    for layer, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == r.shape
        differ = (_topk_sets(p, k) != _topk_sets(r, k)).any(axis=1)
        bound = float(np.abs(p - r)[~differ].max())
        for t in np.flatnonzero(differ):
            gaps = (float(_gap(p, k)[t]), float(_gap(r, k)[t]))
            assert max(gaps) <= bound, (layer, t, gaps, bound)
            ties.append((layer, int(t)))
    return ties


def _reached(ties, b, s):
    """(b, s) mask of the positions a near-tie reaches: in its row, from
    its position on (tokens are flattened (b, s) in the MoE layer)."""
    mask = np.zeros((b, s), bool)
    for _, t in ties:
        mask[t // s, t % s:] = True
    return mask


# -- whole model ---------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params, port cfg, port model) of one
    reduced MoE arch, on the reference's init."""
    arch = request.param
    rcfg = ref_configs.get_config(arch, reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = port_configs.get_config(arch, reduced=True)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _tokens(cfg, seed=2, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_and_routing_match_reference(pair, monkeypatch):
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg)
    pos = jnp.arange(S, dtype=jnp.int32)
    want, rl = _ref_logits(lambda: jax.jit(
        lambda p, t: ref_transformer.forward(p, rcfg, REF_RULES, t, pos)[0])(
            params, jnp.asarray(toks)), monkeypatch)
    with torch.no_grad():
        (got, cache), pl = _port_logits(lambda: transformer.forward(
            model, cfg, None, torch.as_tensor(toks),
            torch.arange(S, dtype=torch.int32)), monkeypatch)
    assert cache is None and got.dtype == torch.float32
    assert len(pl) == cfg.num_layers
    ties = _near_ties(pl, rl, cfg.num_experts_per_tok)
    print(f"\n{cfg.arch}: {len(ties)} near-ties {ties}")
    keep = ~_reached(ties, B, S)
    np.testing.assert_allclose(got.numpy()[keep], _np(want)[keep], **TOL)


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill S-1 tokens, decode the S-th from the cache: the last logits
    equal the full forward's, inside the port (B·S = 48 tokens: C >= N at
    the reduced configs' capacity factor 4, so neither call drops)."""
    _, _, cfg, model = pair
    toks = torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        full = transformer.forward(model, cfg, None, toks,
                                   torch.arange(S, dtype=torch.int32))[0]
    cache = M.make_cache(cfg, B, S + 8, device="cpu")
    _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks[:, :S - 1]},
                            cache)
    step, _ = M.decode_fn(model, cfg, None, toks[:, S - 1:], S - 1, cache)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_cache_matches_reference_after_prefill_and_decode(pair):
    """Prefill then 3 teacher-forced decode steps on both sides: the caches
    after each phase (K/V at rtol 2e-2 and an atol of one bf16 ulp of the
    largest entry, as ``test_torch_models.py`` states; slot positions
    exactly) and every step's logits at the reference's bound."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, seed=5)
    S0, cap = S - 3, S + 8
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
    rl, rc = ref_transformer.prefill(params, rcfg, REF_RULES,
                                     jnp.asarray(toks[:, :S0]), rc)
    pl, pc = transformer.prefill(model, cfg, None,
                                 torch.as_tensor(toks[:, :S0]), pc)
    np.testing.assert_allclose(pl.numpy(), _np(rl), **TOL)
    caches_close(pc, rc)
    for s in range(3):
        tok = toks[:, S0 + s:S0 + s + 1]
        rl, rc = ref_transformer.decode_step(params, rcfg, REF_RULES,
                                             jnp.asarray(tok),
                                             jnp.asarray(S0 + s), rc)
        pl, pc = transformer.decode_step(model, cfg, None,
                                         torch.as_tensor(tok), S0 + s, pc)
        np.testing.assert_allclose(pl.numpy(), _np(rl), err_msg=f"step{s}",
                                   **TOL)
    caches_close(pc, rc)


def _batch(rcfg, seed=0, b=4, s=16):
    from repro.data import lm_batch as ref_lm_batch
    rb = ref_lm_batch(rcfg, seed=seed, step=0, batch=b, seq=s)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_loss_and_gradients_match_reference(pair, monkeypatch):
    """The loss at rtol 1e-3 and each leaf's gradient at the dense
    family's bounds (``test_torch_train.py``): relative Frobenius error at
    most 0.15 and at most a quarter of the distance of the reference's
    bf16 gradient from the port's fp32 one; the router's gradient is fp32
    on both sides.  The batch's routing agrees up to proven near-ties."""
    rcfg, params, cfg, model = pair
    rb, pb = _batch(rcfg)
    (rloss, rg), rl = _ref_logits(lambda: jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, REF_RULES, b)))(params, rb),
        monkeypatch)
    (loss, pg), pl = _port_logits(
        lambda: _value_and_grad(make_loss(cfg, None), model, pb),
        monkeypatch)
    ties = _near_ties(pl, rl[:len(pl)], cfg.num_experts_per_tok)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-3)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    _, g32 = _value_and_grad(make_loss(cfg32, None), tree_map(
        lambda w: w.float(), model), pb)
    rows = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(rg)[0]:
        got = _leaf(pg, path)
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
        assert tuple(got.shape) == leaf.shape
        want = _np(leaf)
        rows.append((jax.tree_util.keystr(path), _fro(_np(got), want),
                     _fro(want, _np(_leaf(g32, path)))))
    print(f"\n{cfg.arch} near-ties {ties}; per-leaf relative Frobenius "
          "error (port vs reference; reference bf16 vs fp32):",
          [f"{k} {e:.2e} {n:.2e}" for k, e, n in rows])
    for key, err, noise in rows:
        assert err <= GRAD_FRO, (key, err)
        assert err <= GRAD_NOISE_SHARE * noise, (key, err, noise)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_float64_gradient_against_a_central_difference(arch, remat):
    """A float64 config runs in float64 end to end, the router included:
    autograd meets the float64 loss's central difference along a random
    unit direction to rtol 1e-6 at step 1e-5 (a step that small crosses no
    routing boundary of this batch)."""
    cfg = dataclasses.replace(port_configs.get_config(arch, reduced=True),
                              dtype=torch.float64, param_dtype=torch.float64,
                              remat=remat)
    tree = tree_map(lambda w: w.double(), M.init_params(cfg, 0, device="cpu"))
    _, pb = _batch(ref_configs.get_config(arch, reduced=True), seed=1)
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


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    """``none``, ``dots`` and ``full`` give the same gradients bit for bit.
    Under ``dots`` the backward recomputes the products with a batch
    dimension (the experts' ``bmm``, a batch of E, and attention's) and the
    dispatch, whose recomputed routing must equal the forward's; the
    un-batched products (``mm``: projections, router, dense residual) are
    saved."""
    base = port_configs.get_config(arch, reduced=True)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(ref_configs.get_config(arch, reduced=True), seed=2)
    grads, ops = {}, {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        xs = tree_map(lambda p: p.detach().requires_grad_(), tree)
        loss = M.loss_fn(xs, cfg, None, pb)
        with _CountOps() as counter:
            grads[mode] = torch.autograd.grad(loss, tree_leaves(xs))
        ops[mode] = counter.ops
    for mode in ("dots", "full"):
        for a, b in zip(grads["none"], grads[mode]):
            assert torch.equal(a, b), mode
    assert ops["dots"]["mm"] == ops["none"]["mm"], ops
    assert ops["none"]["bmm"] < ops["dots"]["bmm"] <= ops["full"]["bmm"]
    # the dispatch ran again in the backward: its sort and its scatter
    assert ops["none"]["sort"] == 0 < ops["dots"]["sort"] == \
        ops["full"]["sort"]


def test_adamw_train_step_matches_reference(pair):
    """One AdamW step from the same weights and batch: the loss at rtol
    2e-3 and the params at the reference's accumulation bound (rtol 2e-2,
    atol 2e-3), the fp32 router included."""
    rcfg, params, cfg, model = pair
    rb, pb = _batch(rcfg, seed=3)
    ropt, popt = RT.AdamW(), AdamW()
    rstep = jax.jit(RT.make_train_step(rcfg, REF_RULES, ropt,
                                       lambda s: 1e-4))
    pstep = make_train_step(cfg, None, popt, lambda s: 1e-4)
    tree = tree_map(lambda t: t.clone(), model)
    rp, _, rm = rstep(params, ropt.init(params), rb, 0)
    tree, _, pm = pstep(tree, popt.init(tree), pb, 0)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=2e-3)
    assert tree["layers"]["router"].dtype == torch.float32
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        np.testing.assert_allclose(_np(_leaf(tree, path)), _np(want),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))


# -- sizes, interop, launchers ---------------------------------------------------

FULL = {"granite-moe-1b-a400m": (1_334_756_352, 0.3212471604705276),
        "arctic-480b": (476_850_275_328, 0.03268177701539624)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sizes_equal_reference_at_full_size(arch):
    cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    n, ratio = FULL[arch]
    assert M.count_params(cfg) == RM.count_params(rcfg) == n
    assert M.active_param_ratio(cfg) == RM.active_param_ratio(rcfg) == ratio
    shapes = M.param_shapes(cfg)
    assert shapes["layers"]["router"].dtype == torch.float32
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert [p for p, _ in tree_items(shapes)] == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(RM.param_shapes(rcfg))[0]]
    assert type(default_optimizer(cfg)).__name__ == \
        type(RT.default_optimizer(rcfg)).__name__ == (
            "Adafactor" if arch == "arctic-480b" else "AdamW")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_router_stays_fp32_through_interop(pair, dtype):
    """The reference builds the router in fp32: ``params_from_reference``
    keeps it so (a bf16 router would move every routing decision) and
    ``params_to_reference`` hands it back in fp32, bit for bit."""
    rcfg, params, cfg, model = pair
    assert model["layers"]["router"].dtype == torch.float32
    assert model["layers"]["e_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(model["layers"]["router"].numpy(),
                                  np.asarray(params["layers"]["router"]))
    tree = params_to_reference(model, dtype=None if dtype is None
                               else jnp.bfloat16)
    assert tree["layers"]["router"].dtype == np.float32
    if dtype:
        assert tree["layers"]["e_up"].dtype == jnp.bfloat16
    back = params_from_reference(tree, cfg, device="cpu")
    for (n, a), (m, b) in zip(tree_items(model), tree_items(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


def test_launchers_run_granite_reduced_on_the_cpu(capsys):
    done = serve_launcher.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                                "--device", "cpu", "--requests", "3",
                                "--new-tokens", "4", "--diverse-k", "2"])
    out = capsys.readouterr().out.splitlines()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert out[-1].startswith("most diverse 2")
    train_launcher.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=granite-moe-1b-a400m-reduced params=")
    assert [l.split()[1] for l in out[1:]] == ["0", "2"]
