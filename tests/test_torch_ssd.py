"""The port's ssm family (``repro_torch.models.ssd``, mamba2) against the
reference's (``repro.models.ssd``) on the CPU.

Module parity feeds the same seeded numpy inputs to both packages (the
reference's functions jitted, so its compiled graph's roundings hold):
``_segsum``, ``ssd_chunked`` at s a multiple of the chunk, at s not one
(the chunk shrinks until it divides s) and at s below it,
``_causal_conv`` with and without a left context, and ``_ssm_sublayer``
on its chunked path and on its recurrence from a cache.  fp32 is held
within rtol 1e-5 (and an atol of 1e-5 of the largest entry: the packages
sum in other orders), bf16 within the reference's 2e-2.  Inside the port,
the chunked scan and the recurrence agree in float64 within 1e-10
(relative Frobenius), values and gradients.

Whole-model parity runs ``mamba2-130m`` at ``reduced=True`` on the
reference's own init carried by ``interop.params_from_reference``, at the
dense family's bounds (``test_torch_models.py``, ``test_torch_train.py``):
logits at rtol = atol = 2e-2; the cache (state and conv rows) after a
prefill and after 3 decode steps at rtol 2e-2 and an atol of one bf16 ulp
of the largest entry (2^-7 of it), ``pos`` exactly; the loss at rtol 1e-3;
per-leaf bf16 gradients at relative Frobenius 0.15 and a quarter of the
reference's own bf16-vs-fp32 distance (``BF16_SUMMED`` says where the
reference's bf16 sums take the place of the second bound); the float64
gradient against a
central difference at rtol 1e-6; one AdamW step at the reference's
accumulation bound (rtol 2e-2, atol 2e-3); the engine's tokens equal.
"""
import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
import repro.models as RM
import repro.train as RT
from repro.data import lm_batch as ref_lm_batch
from repro.models import ssd as ref_ssd
from repro.models.common import ShardingRules as RefRules
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import ssd
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import (AdamW, default_optimizer, make_loss,
                               make_train_step)
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_map

ARCH = "mamba2-130m"
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
FP32_RTOL = 1e-5
F64_FRO = 1e-10
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
# leaves whose gradient is a bf16 operand's broadcast summed over the batch
# and the sequence: the reference's compiled graph rounds that sum to bf16
# after every add (its reduce region converts each partial sum to bf16),
# the port sums in fp32 and rounds once (torch's reduction), so the
# reference's own accumulation error is most of the distance between the
# two (read 1.1e-2-1.4e-2, against 2.8e-2-4.0e-2 between the reference's
# bf16 and fp32 gradients).  There the distance is held to one reference
# bf16-vs-fp32 distance instead of a quarter of it
BF16_SUMMED = ("['layers']['Dskip']", "['layers']['conv_b']",
               "['layers']['conv_w']")
B, S = 2, 24
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
    """``a`` as the reference's and the port's array in ``dtype`` (both
    round the same float32 values to nearest-even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(np.asarray(a)).to(tdt)


def _cfgs(dtype="bfloat16"):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_configs.get_config(ARCH, reduced=True)
    cfg = port_configs.get_config(ARCH, reduced=True)
    return (dataclasses.replace(rcfg, dtype=jdt, param_dtype=jdt),
            dataclasses.replace(cfg, dtype=tdt, param_dtype=tdt))


def _scan_inputs(b, s, h, p, n, seed):
    """Seeded float32 inputs of ``ssd_chunked``: x (b, s, h, p), dtA < 0
    (b, s, h), B, C (b, s, n)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            -rng.uniform(0.01, 0.6, size=(b, s, h)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32) / 2,
            rng.normal(size=(b, s, n)).astype(np.float32) / 2)


# -- module parity ---------------------------------------------------------------

def test_segsum_matches_reference():
    x = -np.random.default_rng(0).uniform(0, 1, size=(2, 3, 20)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(ref_ssd._segsum)(jnp.asarray(x)))
    got = ssd._segsum(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 3, 20, 20)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=FP32_RTOL,
                               atol=FP32_RTOL * float(np.abs(want[live])
                                                      .max()))


# (s, chunk): a multiple of the chunk, not a multiple (l shrinks to 20),
# shorter than the chunk
SCAN_CASES = [(64, 32), (40, 32), (12, 32)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,chunk", SCAN_CASES,
                         ids=[f"s{s}-l{c}" for s, c in SCAN_CASES])
def test_ssd_chunked_matches_reference(s, chunk, dtype):
    """y and the final state; x, B and C in ``dtype`` (dtA fp32, as the
    layer feeds it)."""
    x, dtA, B_, C_ = _scan_inputs(2, s, 3, 8, 16, seed=s)
    (rx, px), (rb, pb), (rc, pc) = (_both(a, dtype) for a in (x, B_, C_))
    want = jax.jit(ref_ssd.ssd_chunked, static_argnums=4)(
        rx, jnp.asarray(dtA), rb, rc, chunk)
    got = ssd.ssd_chunked(px, torch.as_tensor(dtA), pb, pc, chunk)
    for g, w, name in zip(got, want, ("y", "final_state")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(with_prev, dtype):
    rng = np.random.default_rng(3)
    xBC = rng.normal(size=(2, 7, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32) / 2
    bias = rng.normal(size=40).astype(np.float32) / 4
    prev = rng.normal(size=(2, 3, 40)).astype(np.float32)
    (rx, px), (rw, pw), (rbias, pbias), (rp, pp) = (
        _both(a, dtype) for a in (xBC, w, bias, prev))
    want = jax.jit(ref_ssd._causal_conv)(rx, rw, rbias,
                                         rp if with_prev else None)
    got = ssd._causal_conv(px, pw, pbias, pp if with_prev else None)
    for g, w_, name in zip(got, want, ("out", "new_prev")):
        assert str(g.dtype).split(".")[-1] == str(w_.dtype)
        _close(g, w_, dtype, name)


def _layer_weights(cfg, seed):
    """Seeded float32 weights of one mamba2 layer, by name."""
    rng = np.random.default_rng(seed)
    D, DI, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv)
    cd = DI + 2 * N
    return {"ln": rng.normal(size=D) * 0.1,
            "in_proj": rng.normal(size=(D, 2 * DI + 2 * N + H)) / np.sqrt(D),
            "conv_w": rng.normal(size=(K, cd)) / 2,
            "conv_b": rng.normal(size=cd) * 0.1,
            "dt_bias": rng.normal(size=H) * 0.5,
            "A_log": rng.normal(size=H) * 0.5,
            "Dskip": 1 + 0.1 * rng.normal(size=H),
            "gate_ln": 0.1 * rng.normal(size=DI),
            "out_proj": rng.normal(size=(DI, D)) / np.sqrt(DI)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["train", "cache"])
def test_ssm_sublayer_matches_reference(mode, dtype):
    """The chunked path on 70 tokens (l = 14 of the chunk 32), and the
    recurrence over 5 tokens from a random fp32 state and bf16 conv rows:
    the layer's output, and the new state and conv rows."""
    rcfg, cfg = _cfgs(dtype)
    lw = {k: np.asarray(v, np.float32) for k, v in
          _layer_weights(cfg, 5).items()}
    rlp, plp = {}, {}
    for k, v in lw.items():
        rlp[k], plp[k] = _both(v, dtype)
    plp = types.SimpleNamespace(**plp)
    rng = np.random.default_rng(6)
    s = 70 if mode == "train" else 5
    rx, px = _both(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32),
                   dtype)
    if mode == "train":
        want, _ = jax.jit(lambda x, l: ref_ssd._ssm_sublayer(
            x, l, rcfg, REF_RULES))(rx, rlp)
        got, row = ssd._ssm_sublayer(px, plp, cfg, None)
        assert row is None
        _close(got, want, dtype)
        return
    st = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state)).astype(np.float32)
    cv = rng.normal(size=(2, cfg.ssm_conv - 1, ssd._conv_dim(cfg))) \
        .astype(np.float32)
    rconv, pconv = _both(cv, "bfloat16")
    want, wrow = jax.jit(lambda x, l, r: ref_ssd._ssm_sublayer(
        x, l, rcfg, REF_RULES, r))(rx, rlp, {"state": jnp.asarray(st),
                                              "conv": rconv})
    got, (gstate, gconv) = ssd._ssm_sublayer(
        px, plp, cfg, None, (torch.as_tensor(st), pconv.to(px.dtype)))
    _close(got, want, dtype, "out")
    _close(gstate, wrow["state"], dtype, "state")
    _close(gconv, wrow["conv"], dtype, "conv")


@pytest.mark.parametrize("s", [96, 50])
def test_chunked_scan_and_recurrence_agree_in_float64(s):
    """The two paths compute one function: y and the final state within
    1e-10 relative Frobenius in float64 (3 full chunks of 32; 50 tokens
    make 2 chunks of 25)."""
    x, dtA, B_, C_ = (torch.as_tensor(a, dtype=torch.float64)
                      for a in _scan_inputs(2, s, 3, 8, 16, seed=7))
    y, final = ssd.ssd_chunked(x, dtA, B_, C_, 32)
    y_r, final_r = ssd._ssd_recurrent(x, dtA, B_, C_,
                                      torch.zeros_like(final))
    assert y.dtype == final.dtype == torch.float64
    assert _fro(y.numpy(), y_r.numpy()) <= F64_FRO
    assert _fro(final.numpy(), final_r.numpy()) <= F64_FRO


def test_chunked_gradient_is_finite_and_equals_the_recurrence():
    """The decay mask's -inf entries send nothing back: the chunked scan's
    float64 gradients in x, dtA, B and C are finite and equal the
    recurrence's within 1e-10 relative Frobenius."""
    ins = [torch.as_tensor(a, dtype=torch.float64)
           for a in _scan_inputs(2, 64, 3, 8, 16, seed=8)]
    w = torch.randn((2, 64, 3, 8), generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    grads = []
    for chunked in (True, False):
        xs = [t.clone().requires_grad_() for t in ins]
        if chunked:
            y, final = ssd.ssd_chunked(*xs, 16)
        else:
            y, final = ssd._ssd_recurrent(
                *xs, torch.zeros((2, 3, 8, 16), dtype=torch.float64))
        loss = (y * w).sum() + final.square().sum()
        grads.append(torch.autograd.grad(loss, xs))
    for gc, gr in zip(*grads):
        assert torch.isfinite(gc).all()
        assert _fro(gc.numpy(), gr.numpy()) <= F64_FRO


# -- whole model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) of mamba2
    reduced, on the reference's init."""
    rcfg = ref_configs.get_config(ARCH, reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = port_configs.get_config(ARCH, reduced=True)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return rcfg, params, cfg, model


def _tokens(cfg, seed=2, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_match_reference(pair):
    """40 tokens: chunks of 20 under the reduced config's chunk 32."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, s=40)
    want = jax.jit(lambda p, t: ref_ssd.forward(
        p, rcfg, REF_RULES, t, jnp.arange(40, dtype=jnp.int32))[0])(
            params, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = ssd.forward(model, cfg, None, torch.as_tensor(toks))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill S-1 tokens (the recurrence), decode the S-th from the cache:
    the last logits equal the full forward's (the chunked scan)."""
    _, _, cfg, model = pair
    toks = torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        full = ssd.forward(model, cfg, None, toks)[0]
    cache = M.make_cache(cfg, B, 0, device="cpu")
    _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks[:, :S - 1]},
                            cache)
    step, cache = M.decode_fn(model, cfg, None, toks[:, S - 1:], S - 1, cache)
    assert int(cache.pos) == S
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_cache_matches_reference_after_prefill_and_decode(pair):
    """Prefill then 3 teacher-forced decode steps on both sides: the state
    and conv rows after each phase, ``pos`` exactly, and every step's
    logits at the reference's bound."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, seed=5)
    S0 = S - 3
    rc = RM.make_cache(rcfg, B, S + 8)
    pc = M.make_cache(cfg, B, S + 8, device="cpu")
    assert pc.state.dtype == torch.float32 and pc.conv.dtype == torch.bfloat16
    assert tuple(pc.state.shape) == rc.state.shape
    assert tuple(pc.conv.shape) == rc.conv.shape

    def caches_close(got, want):
        for f in ("state", "conv"):
            w = _np(getattr(want, f))
            np.testing.assert_allclose(_np(getattr(got, f)), w, err_msg=f,
                                       rtol=2e-2,
                                       atol=2 ** -7 * float(np.abs(w).max()))
        assert int(got.pos) == int(want.pos)

    prefill = jax.jit(lambda p, b, c: RM.prefill_fn(p, rcfg, REF_RULES, b, c))
    decode = jax.jit(lambda p, t, pos, c: RM.decode_fn(p, rcfg, REF_RULES, t,
                                                       pos, c))
    rl, rc = prefill(params, {"tokens": jnp.asarray(toks[:, :S0])}, rc)
    pl, pc = M.prefill_fn(model, cfg, None,
                          {"tokens": torch.as_tensor(toks[:, :S0])}, pc)
    np.testing.assert_allclose(pl.numpy(), _np(rl), **TOL)
    caches_close(pc, rc)
    for s in range(3):
        tok = toks[:, S0 + s:S0 + s + 1]
        rl, rc = decode(params, jnp.asarray(tok), jnp.asarray(S0 + s), rc)
        pl, pc = M.decode_fn(model, cfg, None, torch.as_tensor(tok), S0 + s,
                             pc)
        np.testing.assert_allclose(pl.numpy(), _np(rl), err_msg=f"step{s}",
                                   **TOL)
    caches_close(pc, rc)


def _batch(rcfg, seed=0, b=4, s=40):
    rb = ref_lm_batch(rcfg, seed=seed, step=0, batch=b, seq=s)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_loss_and_gradients_match_reference(pair):
    """The loss at rtol 1e-3 and each leaf's bf16 gradient within relative
    Frobenius 0.15 and a quarter of the distance of the reference's bf16
    gradient from the port's fp32 one (40 tokens: two chunks a row); for
    the ``BF16_SUMMED`` leaves, within that whole distance."""
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
    assert {k for k, *_ in rows} >= set(BF16_SUMMED)
    for key, err, noise in rows:
        assert err <= GRAD_FRO, (key, err)
        share = 1.0 if key in BF16_SUMMED else GRAD_NOISE_SHARE
        assert err <= share * noise, (key, err, noise)


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


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_float64_gradient_against_a_central_difference(remat):
    """A float64 config runs in float64 end to end, the scan included:
    autograd meets the float64 loss's central difference along a random
    unit direction to rtol 1e-6 at step 1e-5."""
    cfg = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                              dtype=torch.float64, param_dtype=torch.float64,
                              remat=remat)
    tree = tree_map(lambda w: w.double(), M.init_params(cfg, 0, device="cpu"))
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=1)
    fd, dot = _fd_check(cfg, tree, pb)
    assert fd == pytest.approx(dot, rel=1e-6)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_remat_modes_give_equal_gradients():
    """``none``, ``dots`` and ``full`` give the same gradients bit for bit;
    ``dots`` saves the projections (``mm``) and recomputes the scan's
    batched products (``bmm``), ``full`` recomputes both."""
    base = port_configs.get_config(ARCH, reduced=True)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(ref_configs.get_config(ARCH, reduced=True), seed=2)
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
    assert ops["dots"]["mm"] == ops["none"]["mm"] < ops["full"]["mm"], ops
    assert ops["none"]["bmm"] < ops["dots"]["bmm"] == ops["full"]["bmm"], ops


def test_adamw_train_step_matches_reference(pair):
    """One AdamW step from the same weights and batch: the loss at rtol
    2e-3 and the params at the reference's accumulation bound (rtol 2e-2,
    atol 2e-3)."""
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
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        np.testing.assert_allclose(_np(_leaf(tree, path)), _np(want),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))


# -- sizes, interop, engine, launchers ------------------------------------------------

def test_sizes_equal_reference_at_full_size():
    cfg, rcfg = port_configs.get_config(ARCH), ref_configs.get_config(ARCH)
    assert M.count_params(cfg) == RM.count_params(rcfg) == 129_100_224
    assert M.active_param_ratio(cfg) == RM.active_param_ratio(rcfg) == 1.0
    shapes = M.param_shapes(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    ref = jax.tree_util.tree_flatten_with_path(RM.param_shapes(rcfg))[0]
    assert [(p, tuple(t.shape)) for p, t in tree_items(shapes)] == [
        (jax.tree_util.keystr(p), s.shape) for p, s in ref]
    assert type(default_optimizer(cfg)).__name__ == \
        type(RT.default_optimizer(rcfg)).__name__ == "AdamW"
    c = M.make_cache(cfg, 8, 0, shapes_only=True)
    r = RM.make_cache(rcfg, 8, 0, shapes_only=True)
    assert [tuple(t.shape) for t in c] == [t.shape for t in r]
    assert all(t.device.type == "meta" for t in c)


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


def test_engine_generates_as_the_reference(pair):
    """``ServingEngine.generate`` against the reference's engine: prefill
    steps the recurrence over the left-padded prompts, decode one token a
    step from the state; the tokens are equal (an ssm model's state does
    not grow, so a capacity below the tokens is accepted)."""
    rcfg, params, cfg, model = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 11)))
               .astype(np.int32) for _ in range(6)]
    new = [12, 9, 12, 5, 12, 12]
    want = RefEngine(rcfg, REF_RULES, params, batch=4, capacity=8).generate(
        [RefRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    got = ServingEngine(cfg, None, model, batch=4, capacity=8).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    for g, w in zip(got, want):
        assert g.out.dtype == w.out.dtype
        np.testing.assert_array_equal(g.out, w.out)


def test_launchers_run_mamba2_reduced_on_the_cpu(capsys):
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
