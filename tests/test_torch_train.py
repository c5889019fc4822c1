"""The port's dense-model training (``repro_torch.models.loss_fn``,
``repro_torch.train``, ``repro_torch.launch.train``) against the
reference's (``repro.models.loss_fn``, ``repro.train``) on the CPU.

The weights are the reference's own init, carried across by
``interop.params_from_reference``, a tree of tensors in the reference's
layout.  Tolerances, stated per check:

* loss: rtol 1e-3 (the forward's logits agree to 4-8e-3; the loss, a mean
  over tokens, to ~2e-5);
* per-leaf gradients in bf16: relative Frobenius error at most 0.15, and
  at most a quarter of the distance of the reference's bf16 gradient from
  the fp32 gradient of the same weights.  The random reduced models are
  chaotic in bf16: each package's bf16 gradient parts from the fp32 one by
  0.03-1.8 (relative Frobenius), while the two packages part from each
  other by 2e-3-9e-2;
* the fp32 gradient against a central difference of the fp32 loss along a
  random unit direction, step 1e-3: relative error at most 2e-2 (fp32
  rounding of the loss over the step, ~1e-3, and the curvature); the
  float64 gradient against the float64 loss's, step 1e-5: rtol 1e-6;
* the optimizers' arithmetic given the same fp32 gradients: rtol 1e-6,
  and an atol of 1e-6 of the leaf's largest entry (a param that crosses
  zero keeps the update's absolute error, ~1e-9);
* three train steps at lr 1e-4: losses rtol 2e-3, params rtol 2e-2 and
  atol 2e-3 (the reference's accumulation bound; Adam's first steps move
  an entry by ~lr whatever its gradient's size, so entries whose bf16
  gradients differ in sign part by ~2 lr a step), the step-0 gradient
  norm rtol 3e-2 (the gradients' bf16 noise).

The reference's own ``tests/test_train.py`` cases are mirrored below
(``test_adafactor_trains`` on mamba2, as the reference's, and on a dense
arch).  The MoE family's training parity is ``test_torch_moe.py``, the
ssm and vlm families' ``test_torch_ssd.py`` and ``test_torch_vlm.py``.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
import repro.models as RM
import repro.train as RT
from repro.checkpoint import CheckpointManager as RefManager
from repro.data import lm_batch as ref_lm_batch
from repro.distributed import ResiliencePolicy as RefPolicy
from repro.distributed import TrainingSupervisor as RefSupervisor
from repro.models.common import ShardingRules as RefRules
import repro_torch.models as M
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import keystr_paths
from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.distributed import ResiliencePolicy, TrainingSupervisor
from repro_torch.interop import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference)
from repro_torch.launch import train as launcher
from repro_torch.train import (Adafactor, AdamW, cosine_schedule,
                               default_lr, default_optimizer,
                               get_optimizer, make_decode_step, make_loss,
                               make_prefill_step, make_train_step)
from repro_torch.tree import tree_items, tree_leaves, tree_map
from repro_torch.train.step import _value_and_grad

DENSE = ["gemma-2b", "internlm2-1.8b", "starcoder2-15b", "gemma2-27b"]
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
GRAD_FRO = 0.15
GRAD_NOISE_SHARE = 0.25
FD_EPS, FD_RTOL = 1e-3, 2e-2
OPT_RTOL = 1e-6


def _ref_params(arch, seed=0):
    rcfg = ref_configs.get_config(arch, reduced=True)
    return rcfg, RM.init_params(rcfg, jax.random.PRNGKey(seed))


def _port_tree(params, cfg):
    return params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")


def _batch(cfg, seed=0, b=4, s=16):
    rb = ref_lm_batch(ref_configs.get_config(cfg.arch.replace("-reduced", ""),
                                             reduced=True),
                      seed=seed, step=0, batch=b, seq=s)
    return rb, {k: torch.as_tensor(np.array(v)) for k, v in rb.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else getattr(tree, k.name)
    return tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _fro(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _leaves(state):
    """An optimizer state's leaves in JAX's order (fields, then keys)."""
    return [x for f in state for x in tree_leaves(f)]


# -- loss ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE)
def ref_grads(request):
    """(arch, reference params, batches, the reference's loss and
    gradients), one jitted ``value_and_grad`` an arch."""
    arch = request.param
    rcfg, params = _ref_params(arch)
    rb, pb = _batch(get_config(arch, reduced=True))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, REF_RULES, b)))(params, rb)
    return arch, params, pb, float(loss), grads


def test_loss_matches_reference(ref_grads):
    arch, params, pb, want, _ = ref_grads
    cfg = get_config(arch, reduced=True)
    tree = _port_tree(params, cfg)
    got = M.loss_fn(tree, cfg, None, pb)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-3)
    # the serving path (no gradients, no remat) computes the same loss
    with torch.no_grad():
        assert torch.equal(M.loss_fn(tree, cfg, None, pb), got)


@pytest.mark.parametrize("masked", [False, True])
def test_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3) if masked else None
    want = float(RM._xent(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask)))
    got = M._xent(torch.as_tensor(logits), torch.as_tensor(labels),
                  None if mask is None else torch.as_tensor(mask))
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_other_families_raise_naming_their_slice():
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True),
                              family="no-such-family")
    with pytest.raises(ValueError, match="no-such-family"):
        M.loss_fn({}, cfg, None, {"tokens": torch.zeros((1, 2))})
    assert M.active_param_ratio(get_config("granite-moe-1b-a400m")) == \
        RM.active_param_ratio(ref_configs.get_config("granite-moe-1b-a400m"))
    for arch in ("internlm2-1.8b", "gemma2-27b", "mamba2-130m"):
        assert M.active_param_ratio(get_config(arch)) == \
            RM.active_param_ratio(ref_configs.get_config(arch)) == 1.0


# -- gradients -----------------------------------------------------------------

def _fp32(cfg, tree):
    return (dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32),
            tree_map(lambda w: w.float(), tree))


def test_gradients_match_reference(ref_grads):
    arch, params, pb, _, rg = ref_grads
    cfg = get_config(arch, reduced=True)
    tree = _port_tree(params, cfg)
    _, pg = _value_and_grad(make_loss(cfg, None), tree, pb)
    cfg32, t32 = _fp32(cfg, tree)
    _, g32 = _value_and_grad(make_loss(cfg32, None), t32, pb)
    rows = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(rg)[0]:
        got = _leaf(pg, path)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == leaf.shape
        want = _np(leaf)
        err = _fro(_np(got), want)
        noise = _fro(want, _np(_leaf(g32, path)))
        rows.append((jax.tree_util.keystr(path), err, noise))
    print(f"\n{arch} per-leaf relative Frobenius error (port vs reference; "
          "reference bf16 vs fp32):", [f"{k} {e:.2e} {n:.2e}"
                                       for k, e, n in rows])
    for key, err, noise in rows:
        assert err <= GRAD_FRO, (key, err)
        assert err <= GRAD_NOISE_SHARE * noise, (key, err, noise)


def _directional_check(cfg, tree, batch, eps, seed=1):
    """(central difference of the fp32 loss along a random unit direction,
    <grad, direction>) at the fp32 copy of ``tree``."""
    cfg32, t32 = _fp32(cfg, tree)
    loss_fn = make_loss(cfg32, None)
    _, grads = _value_and_grad(loss_fn, t32, batch)
    gen = torch.Generator().manual_seed(seed)
    d = tree_map(lambda w: torch.randn(w.shape, generator=gen), t32)
    norm = torch.sqrt(sum((x * x).sum() for x in tree_leaves(d)))
    d = tree_map(lambda x: x / norm, d)
    dot = float(sum((g * x).sum() for g, x in zip(tree_leaves(grads),
                                                  tree_leaves(d))))
    with torch.no_grad():
        lp = float(loss_fn(tree_map(lambda w, x: w + eps * x, t32, d),
                           batch))
        lm = float(loss_fn(tree_map(lambda w, x: w - eps * x, t32, d),
                           batch))
    return (lp - lm) / (2 * eps), dot


@pytest.mark.parametrize("arch", DENSE)
def test_fp32_gradient_against_a_central_difference(arch):
    cfg = get_config(arch, reduced=True)
    tree = M.init_params(cfg, 0, device="cpu")
    _, pb = _batch(cfg, seed=1)
    fd, dot = _directional_check(cfg, tree, pb, FD_EPS)
    rel = abs(fd - dot) / abs(dot)
    print(f"\n{arch}: central difference {fd:.6e}, <grad, d> {dot:.6e}, "
          f"relative error {rel:.2e} (eps {FD_EPS})")
    assert rel <= FD_RTOL


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run (a cached output of a selective
    checkpoint does not run)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
def test_float64_gradient_against_a_central_difference(arch, remat):
    """A float64 config runs in float64 end to end (the reference's fp32
    upcasts keep float64), so autograd meets a float64 central difference
    along a random unit direction to rtol 1e-6 at step 1e-5 (truncation
    ~eps^2, rounding ~1e-16 / eps)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float64, param_dtype=torch.float64,
                              remat=remat)
    tree = tree_map(lambda w: w.double(),
                    M.init_params(cfg, 0, device="cpu"))
    _, pb = _batch(cfg, seed=1)
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


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
def test_remat_modes_give_equal_gradients(arch):
    """``none``, ``dots`` and ``full`` compute the same gradients bit for
    bit.  In the backward pass ``full`` recomputes the forward's matrix
    products and ``dots`` none of them (they are saved), while ``dots``
    still recomputes the rest of the layer."""
    base = get_config(arch, reduced=True)
    tree = M.init_params(base, 0, device="cpu")
    _, pb = _batch(base, seed=2)
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
    products = {m: ops[m]["mm"] + ops[m]["bmm"] for m in ops}
    assert products["dots"] < products["full"], products
    assert sum(ops["none"].values()) < sum(ops["dots"].values()) \
        < sum(ops["full"].values()), ops
    # dots recomputes only the batched (attention) products
    assert ops["dots"]["mm"] == ops["none"]["mm"], ops


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_gradients_match_the_reference_in_bf16(act):
    """The activations' backward in bf16 against ``jax.grad`` of the
    reference's, at pre-activations up to +-200 (a full-width layer's reach
    past -88.7, where e^-x overflows bf16): finite (the chain rule through
    silu's ops gives 0 * inf = NaN there; the sigmoid's backward is
    lax.logistic's), silu's within one bf16 ulp of each entry (and 1e-30
    where it underflows), gelu's within 2^-6 (two ulps at 1: JAX
    differentiates x ** 3 as 3 x^2, the port the product x x x, each op
    rounded to bf16)."""
    from repro_torch.models.common import _act
    ref_act = {"silu": jax.nn.silu,
               "gelu": lambda x: jax.nn.gelu(x, approximate=True)}[act]
    xs = np.concatenate([np.linspace(-200, 200, 4001),
                         np.random.default_rng(0).normal(size=4000) * 3])
    x = jnp.asarray(xs, jnp.bfloat16)
    want = _np(jax.grad(lambda v: jnp.sum(ref_act(v).astype(jnp.float32)))(
        x))
    t = torch.as_tensor(xs, dtype=torch.bfloat16).requires_grad_()
    _act(act)(t).float().sum().backward()
    got = _np(t.grad)
    assert np.isfinite(got).all()
    tol = dict(rtol=2.0 ** -7, atol=1e-30) if act == "silu" else \
        dict(rtol=0, atol=2.0 ** -6)
    np.testing.assert_allclose(got, want, **tol)


def test_remat_rejects_an_unknown_mode():
    from repro_torch.models.common import maybe_remat
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True),
                              remat="some")
    with pytest.raises(ValueError, match="remat"):
        maybe_remat(lambda x: x, cfg)


# -- optimizers ------------------------------------------------------------------

def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32)
                        * 0.3, params)


OPTIMIZERS = {
    "adamw": (lambda: RT.AdamW(), lambda: AdamW()),
    "adamw_wd0": (lambda: RT.AdamW(weight_decay=0.0),
                  lambda: AdamW(weight_decay=0.0)),
    "adafactor": (lambda: RT.Adafactor(), lambda: Adafactor()),
    "adafactor_beta1_wd": (
        lambda: RT.Adafactor(beta1=0.9, weight_decay=0.01),
        lambda: Adafactor(beta1=0.9, weight_decay=0.01)),
}


def _assert_opt_close(got, want, key):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * float(np.abs(want).max()),
                               err_msg=key)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_matches_reference(name, arch):
    """Two updates from the same params and fp32 gradients.  Adafactor on
    fp32 params (its cast back to bf16 would round the 1e-6 agreement to
    bf16 steps); AdamW on bf16 params, whose fp32 master is compared and
    the params must be the master rounded to bf16.  gemma2's stacked
    ``(G, P, D)`` norm leaves (P = 2) are factored over (P, D), and the
    clip's RMS is taken over each whole leaf, as in the reference."""
    rcfg, params = _ref_params(arch)
    cfg = get_config(arch, reduced=True)
    ref_opt, port_opt = (f() for f in OPTIMIZERS[name])
    if name.startswith("adafactor"):
        params = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    tree = tree_map(lambda t: torch.as_tensor(np.array(t, np.float32))
                    .to(torch.bfloat16 if t.dtype == jnp.bfloat16
                        else torch.float32),
                    jax.tree.map(np.asarray, params))
    rs, ps = ref_opt.init(params), port_opt.init(tree)
    ref_update = jax.jit(ref_opt.update)
    assert keystr_paths(ps) == [jax.tree_util.keystr(p) for p, _ in
                                jax.tree_util.tree_flatten_with_path(rs)[0]]
    rp = params
    for i, lr in enumerate((1e-2, cosine_schedule(1e-2, 2, 10))):
        g = _grads_like(params, seed=i)
        rlr = lr if isinstance(lr, float) else RT.cosine_schedule(
            1e-2, 2, 10)(i + 1)
        plr = lr if isinstance(lr, float) else lr(i + 1)
        rp, rs = ref_update(jax.tree.map(jnp.asarray, g), rs, rp, rlr)
        tree, ps = port_opt.update(tree_map(torch.as_tensor, g), ps, tree,
                                   plr)
    assert int(ps.step) == int(rs.step) == 2
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(rs)[0],
                                 _leaves(ps)):
        key = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, key
        _assert_opt_close(got, want, key)
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        got = _leaf(tree, path)
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32)
        if name.startswith("adamw"):
            master = _leaf(ps.master, path)
            assert torch.equal(got, master.to(got.dtype))
        else:
            _assert_opt_close(got, want, jax.tree_util.keystr(path))


def test_state_shapes_and_specs():
    cfg = get_config("gemma2-27b")                 # full size, on meta
    rcfg = ref_configs.get_config("gemma2-27b")
    shapes, rshapes = M.param_shapes(cfg), RM.param_shapes(rcfg)
    for opt, ropt in ((AdamW(), RT.AdamW()), (Adafactor(beta1=0.9),
                                              RT.Adafactor(beta1=0.9))):
        st, rst = opt.state_shapes(shapes), ropt.state_shapes(rshapes)
        assert keystr_paths(st) == [jax.tree_util.keystr(p) for p, _ in
                                    jax.tree_util.tree_flatten_with_path(
                                        rst)[0]]
        for got, (_, want) in zip(_leaves(st),
                                  jax.tree_util.tree_flatten_with_path(
                                      rst)[0]):
            assert got.device.type == "meta"
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
        # the state's specs from the params' (default rules: fsdp over
        # 'data', heads and experts over 'model'), path for path
        specs = opt.state_specs(M.param_specs(cfg, M.ShardingRules()))
        rspecs = ropt.state_specs(RM.param_specs(rcfg, RefRules()))
        rflat = jax.tree_util.tree_flatten_with_path(
            rspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        got = [(f".{f}{k}", v) for f in specs._fields
               for k, v in tree_items(getattr(specs, f))]
        assert [k for k, _ in got] == [jax.tree_util.keystr(p)
                                       for p, _ in rflat]
        assert [tuple(v) for _, v in got] == [tuple(v) for _, v in rflat]
    assert isinstance(get_optimizer("adamw"), AdamW)
    assert isinstance(get_optimizer("adafactor"), Adafactor)
    with pytest.raises(KeyError):
        get_optimizer("sgd")


def test_cosine_schedule_matches_reference():
    ref = RT.cosine_schedule(3e-4, warmup=10, total=100)
    lr = cosine_schedule(3e-4, warmup=10, total=100)
    steps = np.arange(0, 121)
    want = np.asarray([float(ref(s)) for s in steps], np.float32)
    got = np.asarray([float(lr(s)) for s in steps], np.float32)
    assert lr(5).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_opt_state_interop_round_trip():
    rcfg, params = _ref_params("gemma2-27b")
    for ropt in (RT.AdamW(), RT.Adafactor()):
        rs = jax.tree.map(np.asarray, ropt.init(params))
        ps = opt_state_from_reference(rs, device="cpu")
        assert type(ps).__name__ == type(rs).__name__
        back = opt_state_to_reference(ps)
        for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(tuple(back))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        opt_state_from_reference({"w": 1}, device="cpu")


# -- train steps ---------------------------------------------------------------

@pytest.mark.parametrize("compress", [None, "bf16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_reference(name, compress):
    rcfg, params = _ref_params("internlm2-1.8b")
    cfg = get_config("internlm2-1.8b", reduced=True)
    ref_opt, port_opt = (f() for f in OPTIMIZERS[name])
    rb, pb = _batch(cfg)
    tree = _port_tree(params, cfg)
    rs, ps = ref_opt.init(params), port_opt.init(tree)
    rstep = jax.jit(RT.make_train_step(rcfg, REF_RULES, ref_opt,
                                       lambda s: 1e-4,
                                       compress_grads=compress))
    pstep = make_train_step(cfg, None, port_opt, lambda s: 1e-4,
                            compress_grads=compress)
    for i in range(3):
        params, rs, rm = rstep(params, rs, rb, i)
        tree, ps, pm = pstep(tree, ps, pb, i)
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=2e-3)
        assert float(pm["lr"]) == float(rm["lr"])
        if i == 0:
            assert float(pm["grad_norm"]) == pytest.approx(
                float(rm["grad_norm"]), rel=3e-2)
        for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
            np.testing.assert_allclose(_np(_leaf(tree, path)), _np(want),
                                       rtol=2e-2, atol=2e-3)


def test_accumulation_sums_in_fp32_and_rejects_a_ragged_split():
    cfg = get_config("internlm2-1.8b", reduced=True)
    tree = M.init_params(cfg, 1, device="cpu")
    _, pb = _batch(cfg, seed=3)

    class Spy(AdamW):
        def update(self, grads, state, params, lr):
            seen.extend(g.dtype for g in tree_leaves(grads))
            return super().update(grads, state, params, lr)
    for accum, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        seen = []
        step = make_train_step(cfg, None, Spy(), lambda s: 1e-3,
                               accum_steps=accum)
        step(_clone(tree), Spy().init(tree), pb, 0)
        assert set(seen) == {dtype}
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(cfg, None, AdamW(), lambda s: 1e-3,
                        accum_steps=3)(tree, AdamW().init(tree), pb, 0)
    with pytest.raises(ValueError, match="compress_grads"):
        make_train_step(cfg, None, AdamW(), lambda s: 1e-3,
                        compress_grads="int8")


def test_serving_steps_take_the_argmax_of_the_last_position():
    cfg = get_config("gemma2-27b", reduced=True)
    model = M.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)))
    logits, _ = M.prefill_fn(model, cfg, None, {"tokens": toks},
                             M.make_cache(cfg, 2, 16, device="cpu"))
    cache = M.make_cache(cfg, 2, 16, device="cpu")
    nxt, cache = make_prefill_step(cfg, None)(model, {"tokens": toks}, cache)
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, logits[:, -1].argmax(-1).to(torch.int32))
    want, _ = M.decode_fn(model, cfg, None, nxt[:, None], 12,
                          M.prefill_fn(model, cfg, None, {"tokens": toks},
                                       M.make_cache(cfg, 2, 16,
                                                    device="cpu"))[1])
    got, _ = make_decode_step(cfg, None)(model, nxt[:, None], 12, cache)
    assert torch.equal(got, want[:, -1].argmax(-1).to(torch.int32))


def test_default_optimizer_and_lr():
    for arch in ("internlm2-1.8b", "gemma2-27b"):
        cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
        assert type(default_optimizer(cfg)).__name__ == \
            type(RT.default_optimizer(rcfg)).__name__
        for s in (0, 3, 7, 9):
            assert float(default_lr(cfg, 10)(s)) == pytest.approx(
                float(RT.default_lr(rcfg, 10)(s)), rel=1e-6)


# -- the reference's tests/test_train.py, mirrored -----------------------------

def test_training_reduces_loss():
    cfg = get_config("internlm2-1.8b", reduced=True)
    params = M.init_params(cfg, 0, device="cpu")
    opt = AdamW(weight_decay=0.0)
    state = opt.init(params)
    step_fn = make_train_step(cfg, None, opt, lambda s: 1e-2)
    batch = lm_batch(cfg, seed=0, step=0, batch=4, seq=16, device="cpu")
    losses = []
    for i in range(12):
        params, state, metrics = step_fn(params, state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_grad_accumulation_equivalence():
    cfg = get_config("internlm2-1.8b", reduced=True)
    params = M.init_params(cfg, 1, device="cpu")
    opt = AdamW(weight_decay=0.0)
    batch = lm_batch(cfg, seed=3, step=0, batch=4, seq=16, device="cpu")
    one = make_train_step(cfg, None, opt, lambda s: 1e-3, accum_steps=1)
    two = make_train_step(cfg, None, opt, lambda s: 1e-3, accum_steps=2)
    # the optimizer writes into the params it is given: one copy a run
    p1, _, m1 = one(_clone(params), opt.init(params), batch, 0)
    p2, _, m2 = two(_clone(params), opt.init(params), batch, 0)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        # bf16 params + fp32 accumulation-order differences: a few ulps
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma2-27b"])
def test_adafactor_factored_state_shapes(arch):
    # the reference's case (granite-moe's expert leaves), and gemma2's
    # stacked (G, P, ...) leaves
    cfg = get_config(arch, reduced=True)
    shapes = M.param_shapes(cfg)
    st = Adafactor().state_shapes(shapes)
    flat_r = dict(zip(keystr_paths(st.v_row), tree_leaves(st.v_row)))
    for key, leaf in zip(keystr_paths(shapes), tree_leaves(shapes)):
        if leaf.ndim >= 2:
            assert tuple(flat_r[key].shape) == tuple(leaf.shape[:-1])
        else:
            assert tuple(flat_r[key].shape) == (1,)
    p_elems = sum(l.numel() for l in tree_leaves(shapes))
    v_elems = sum(l.numel() for l in tree_leaves(st.v_row)) + \
        sum(l.numel() for l in tree_leaves(st.v_col))
    assert v_elems < 0.2 * p_elems


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_adafactor_trains(arch):
    # the reference's case is mamba2's; the dense arch that stood in for it
    # before the ssm family was ported stays beside it
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, 2, device="cpu")
    opt = Adafactor(beta1=None)
    state = opt.init(params)
    step_fn = make_train_step(cfg, None, opt, lambda s: 3e-2)
    batch = lm_batch(cfg, seed=0, step=0, batch=4, seq=16, device="cpu")
    losses = []
    for i in range(10):
        params, state, metrics = step_fn(params, state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(lr(55)) < float(lr(20))


# -- checkpoints across packages ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_train_step():
    rcfg = ref_configs.get_config("internlm2-1.8b", reduced=True)
    return rcfg, jax.jit(RT.make_train_step(rcfg, REF_RULES, RT.AdamW(),
                                            lambda s: 1e-4))


def _ref_run(params, steps, ckpt):
    """The reference's supervised AdamW run of internlm2 (reduced); returns
    (final state, losses)."""
    rcfg, raw = _ref_train_step()
    opt = RT.AdamW()

    def step_fn(state, batch, step):
        p, o, m = raw(state[0], state[1], batch, step)
        return (p, o), m
    sup = RefSupervisor(RefManager(ckpt), policy=RefPolicy(
        checkpoint_every=2))
    out = sup.run((params, opt.init(params)), step_fn, steps,
                  lambda s: ref_lm_batch(rcfg, seed=5, step=s, batch=4,
                                         seq=16))
    return out, sup.report.losses


def _port_run(tree, steps, ckpt):
    cfg = get_config("internlm2-1.8b", reduced=True)
    opt = AdamW()
    raw = make_train_step(cfg, None, opt, lambda s: 1e-4)

    def step_fn(state, batch, step):
        p, o, m = raw(state[0], state[1], batch, step)
        return (p, o), m
    sup = TrainingSupervisor(CheckpointManager(ckpt),
                             policy=ResiliencePolicy(checkpoint_every=2))
    out = sup.run((tree, opt.init(tree)), step_fn, steps,
                  lambda s: lm_batch(cfg, seed=5, step=s, batch=4, seq=16,
                                     device="cpu"))
    return out, sup.report.losses


def _assert_state_close(port_state, ref_state, exact=False):
    """Equal leaves (``exact``), or the train-step parity: params and the
    fp32 master at rtol 2e-2 and atol 2e-3, the moments (gradient
    averages) within the gradients' relative Frobenius bound, the step
    equal."""
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(ref_state)[0],
            tree_leaves(port_state[0]) + _leaves(port_state[1])):
        key = jax.tree_util.keystr(path)
        if exact or key.startswith(("[0]", "[1].master", "[1].step")):
            np.testing.assert_allclose(_np(got), _np(want),
                                       rtol=0 if exact else 2e-2,
                                       atol=0 if exact else 2e-3,
                                       err_msg=key)
        else:
            assert _fro(_np(got), _np(want)) <= GRAD_FRO, key


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_training_checkpoint_resumes_across_packages(writer, tmp_path):
    """One package trains 2 steps under its supervisor (a checkpoint every 2
    steps); the other's supervisor, on the same directory with 4 steps,
    resumes at step 2: the restored state is the writer's exactly, and
    steps 2-3 track the writer's own continuation (bf16 tolerances as in
    the train-step parity)."""
    rcfg, params = _ref_params("internlm2-1.8b", seed=3)
    cfg = get_config("internlm2-1.8b", reduced=True)
    tree = _port_tree(params, cfg)
    ckpt = str(tmp_path / "ck")
    if writer == "reference":
        (rp, ro), _ = _ref_run(params, 2, ckpt)
        restored = CheckpointManager(ckpt).restore(2, (tree, AdamW().init(
            tree)))
        _assert_state_close(restored, (rp, ro), exact=True)
        got, losses = _port_run(tree, 4, ckpt)
        want, want_losses = _ref_run(params, 4, str(tmp_path / "alone"))
    else:
        (pp, po), _ = _port_run(tree, 2, ckpt)
        restored = RefManager(ckpt).restore(2, (params,
                                                RT.AdamW().init(params)))
        _assert_state_close((pp, po), restored, exact=True)
        want, losses = _ref_run(params, 4, ckpt)
        got, want_losses = _port_run(_port_tree(params, cfg), 4,
                                     str(tmp_path / "alone"))
    assert len(losses) == 2 and len(want_losses) == 4
    np.testing.assert_allclose(losses, want_losses[2:], rtol=2e-3)
    _assert_state_close(got, want)


def _replayed(clean, fail_at, every):
    """The losses a supervised run reports when the injector fires once at
    each step of ``fail_at``: a failure at step s replays from the last
    checkpoint (every ``every`` steps) or from step 0."""
    out, step, fired = [], 0, set()
    while step < len(clean):
        if step in fail_at and step not in fired:
            fired.add(step)
            step = step // every * every
            continue
        out.append(clean[step])
        step += 1
    return out


@pytest.mark.parametrize("fail_at", [(1, 2), (0, 3, 6)])
def test_supervisor_replays_from_a_fresh_entry_state(fail_at, tmp_path):
    """The AdamW step writes into the params and the state in place, so
    every replay from the entry state must start from a fresh copy of it:
    failures at ``fail_at`` (two before the first checkpoint at step 4,
    and one after it in the second case) give the clean run's losses, each
    replayed step's equal to its first run's, and its final state, bit for
    bit."""
    from repro_torch.distributed import FailureInjector
    cfg = get_config("internlm2-1.8b", reduced=True)
    tree = M.init_params(cfg, 4, device="cpu")
    opt = AdamW()
    raw = make_train_step(cfg, None, opt, lambda s: 1e-3)

    def step_fn(state, batch, step):
        p, o, m = raw(state[0], state[1], batch, step)
        return (p, o), m

    def run(name, injector):
        sup = TrainingSupervisor(
            CheckpointManager(str(tmp_path / name)),
            policy=ResiliencePolicy(checkpoint_every=4, injector=injector,
                                    max_retries=4))
        out = sup.run((_clone(tree), opt.init(tree)), step_fn, 8,
                      lambda s: lm_batch(cfg, seed=6, step=s, batch=4,
                                         seq=16, device="cpu"))
        return out, sup.report

    (cp, co), clean = run("clean", None)
    (kp, ko), killed = run("killed", FailureInjector(fail_at=fail_at))
    assert killed.resumes == len(fail_at)
    assert killed.losses == _replayed(clean.losses, fail_at, 4)
    for a, b in zip(tree_leaves(cp) + _leaves(co),
                    tree_leaves(kp) + _leaves(ko)):
        assert torch.equal(a, b)


# -- the launcher --------------------------------------------------------------

def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    launcher.main(["--arch", "internlm2-1.8b", "--reduced", "--device",
                   "cpu", "--steps", "3", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=internlm2-1.8b-reduced params=")
    assert [l.split()[1] for l in out[1:]] == ["0", "2"]
    launcher.main(["--arch", "gemma2-27b", "--reduced", "--device", "cpu",
                   "--steps", "4", "--batch", "4", "--seq", "8",
                   "--accum", "2", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "done: 4 steps, loss ")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000004"]


def test_launcher_sharded_setup_steps_as_one_rank(tmp_path):
    """The multi-rank launcher's setup (``make_host_mesh``, ``rules_for``,
    the params and state placed as DTensors) on a one-rank gloo group:
    its sharded step is the one-rank path's, bit for bit."""
    from test_torch_mesh import one_rank_mesh
    from repro_torch.models.common import set_current_mesh
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    opt = AdamW()
    batch = lm_batch(cfg, seed=17, step=0, batch=4, seq=8, device="cpu")
    p1 = M.init_params(cfg, 0, device="cpu")
    s1 = opt.init(p1)
    want = make_train_step(cfg, launcher.RULES, opt, lambda s: 1e-3)(
        p1, s1, batch, 0)
    with one_rank_mesh(tmp_path):
        try:
            mesh, rules, (sp, st) = launcher._sharded(cfg, opt, "cpu")
            assert tuple(mesh.mesh_dim_names) == ("data", "model")
            assert rules.fsdp == "data" and rules.experts == "model"
            got = make_train_step(cfg, rules, opt, lambda s: 1e-3)(
                sp, st, batch, 0)
        finally:
            set_current_mesh(None)
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[2][k], want[2][k]), k
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            assert a.to_local().shape == b.shape
            assert torch.equal(a.to_local(), b)
        for a, b in zip(_leaves(got[1]), _leaves(want[1])):
            assert torch.equal(a.to_local(), b)


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--arch", "internlm2-1.8b", "--reduced", "--steps",
                       "1"])
