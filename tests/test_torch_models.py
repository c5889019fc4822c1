"""The port's dense model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the reference's (``repro.models``, ``repro.configs``) on the CPU.

The weights are the reference's own init, carried across by
``interop.params_from_reference``; both sides run in bf16, the published
dtype.  Logits are held at rtol = atol = 2e-2, the reference's own
cache-consistency bound (``tests/test_models.py``): XLA and torch round
bf16 products and fp32 sums in different orders.  Cached K/V are bf16
activations up to ~20 in size, and RoPE's difference of products cancels,
so a one-ulp difference at the operands' scale shows at a small entry:
they are held at rtol 2e-2 and an atol of one bf16 ulp of the tensor's
largest entry (2^-7 of it); slot positions exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as RM
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer
from repro.models.common import ShardingRules as RefRules
import repro_torch.configs as port_configs
import repro_torch.models as M
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.models import attention, transformer
from repro_torch.tree import tree_items

DENSE = ["gemma-2b", "internlm2-1.8b", "starcoder2-15b", "gemma2-27b"]
MOE = ["granite-moe-1b-a400m", "arctic-480b"]
REF_RULES = RefRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                     vocab=None, experts=None, fsdp=None, head_dim=None,
                     state=None)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 24


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(reference cfg, reference params, port cfg, port model) of one
    reduced dense arch, on the reference's init."""
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


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _ref_forward(rcfg, params, toks):
    return ref_transformer.forward(params, rcfg, REF_RULES, jnp.asarray(toks),
                                   jnp.arange(toks.shape[1], dtype=jnp.int32))


def test_forward_logits_match_reference(pair):
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg)
    want = _np(_ref_forward(rcfg, params, toks)[0])
    got, cache = transformer.forward(model, cfg, None, torch.as_tensor(toks),
                                     torch.arange(S, dtype=torch.int32))
    assert cache is None
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _logits(params, cfg, toks, pos):
    """The full forward's logits, without gradients."""
    with torch.no_grad():
        return transformer.forward(params, cfg, None, toks, pos)[0]


def _named(tree, path=""):
    """(path, tensor) of every leaf of a parameter tree, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def test_prefill_decode_matches_teacher_forcing(pair):
    """Prefill S-1 tokens, decode the S-th from the cache: the last logits
    equal the full forward's, inside the port."""
    _, _, cfg, model = pair
    toks = torch.as_tensor(_tokens(cfg))
    full = _logits(model, cfg, toks, torch.arange(S, dtype=torch.int32))
    cache = M.make_cache(cfg, B, S + 8, device="cpu")
    _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks[:, :S - 1]},
                            cache)
    step, _ = M.decode_fn(model, cfg, None, toks[:, S - 1:], S - 1, cache)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_fp32_config_decode_matches_full_forward():
    """The same weights in an fp32 config (which the reference's layer scan
    cannot run: its embedding casts to bf16) compute in fp32 end to end,
    caches included: decode from the cache equals the full forward to fp32
    rounding (rtol = atol = 1e-5)."""
    cfg = port_configs.get_config("internlm2-1.8b", reduced=True)
    model = M.init_params(cfg, 3, device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = params_from_reference(params_to_reference(model), cfg32,
                                device="cpu")
    assert m32["embed"].dtype == torch.float32
    toks = torch.as_tensor(_tokens(cfg, seed=4))
    pos = torch.arange(S, dtype=torch.int32)
    full = _logits(m32, cfg32, toks, pos)
    cache = M.make_cache(cfg32, B, S + 4, device="cpu")
    assert cache.k.dtype == torch.float32
    _, cache = M.prefill_fn(m32, cfg32, None, {"tokens": toks[:, :S - 1]},
                            cache)
    step, _ = M.decode_fn(m32, cfg32, None, toks[:, S - 1:], S - 1, cache)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


def _cache_arrays(cache):
    caches = cache.items() if isinstance(cache, dict) else [("", cache)]
    return {f"{name}{f}": getattr(c, f) for name, c in caches
            for f in ("k", "v", "slot_pos")}


def _assert_caches(got, want):
    got, want = _cache_arrays(got), _cache_arrays(want)
    assert got.keys() == want.keys()
    for name in want:
        if name.endswith("slot_pos"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        else:
            w = _np(want[name])
            np.testing.assert_allclose(_np(got[name]), w, err_msg=name,
                                       rtol=2e-2,
                                       atol=2 ** -7 * float(np.abs(w).max()))


def _run_both(rcfg, params, cfg, model, toks, capacity, split=False,
              steps=3):
    """Prefill then ``steps`` teacher-forced decode steps on both sides;
    the caches after the prefill and at the end, and every step's logits."""
    S0 = toks.shape[1] - steps
    rc = RM.make_cache(rcfg, B, capacity, split_local_global=split)
    pc = M.make_cache(cfg, B, capacity, split_local_global=split,
                      device="cpu")
    rl, rc = ref_transformer.prefill(params, rcfg, REF_RULES,
                                     jnp.asarray(toks[:, :S0]), rc)
    pl, pc = transformer.prefill(model, cfg, None,
                                 torch.as_tensor(toks[:, :S0]), pc)
    out = {"prefill": (pl, rl)}
    _assert_caches(pc, rc)
    for s in range(steps):
        tok = toks[:, S0 + s:S0 + s + 1]
        rl, rc = ref_transformer.decode_step(params, rcfg, REF_RULES,
                                             jnp.asarray(tok),
                                             jnp.asarray(S0 + s), rc)
        pl, pc = transformer.decode_step(model, cfg, None,
                                         torch.as_tensor(tok), S0 + s, pc)
        out[f"step{s}"] = (pl, rl)
    _assert_caches(pc, rc)
    return out


def test_cache_matches_reference_after_prefill_and_decode(pair):
    rcfg, params, cfg, model = pair
    out = _run_both(rcfg, params, cfg, model, _tokens(cfg, seed=5),
                    capacity=S + 8)
    for name, (got, want) in out.items():
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=name,
                                   **TOL)


def test_gemma2_rolling_window_split_cache():
    """gemma2's local layers hold window-sized ring buffers
    (``split_local_global=True``, capacity above the window): a prefill
    longer than the window keeps only its last entries, and decode wraps
    the ring; caches and logits equal the reference's."""
    rcfg = ref_configs.get_config("gemma2-27b", reduced=True)
    cfg = port_configs.get_config("gemma2-27b", reduced=True)
    params = RM.init_params(rcfg, jax.random.PRNGKey(1))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    assert cfg.window == 16
    toks = _tokens(cfg, seed=7, s=cfg.window + 8)
    cache = M.make_cache(cfg, B, 40, split_local_global=True, device="cpu")
    assert cache["local"].k.shape[2] == cfg.window
    assert cache["global"].k.shape[2] == 40
    out = _run_both(rcfg, params, cfg, model, toks, capacity=40, split=True,
                    steps=4)
    for name, (got, want) in out.items():
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "internlm2-1.8b",
                                  "starcoder2-15b"])
def test_pad_heads_branch_is_the_gqa_path(arch):
    """The reference pads the query heads to ``attn_pad_to`` and repeats
    K/V per head (``attn_shard="pad_heads"``), then slices the padding off:
    the same function as the port's one GQA path."""
    rcfg = ref_configs.get_config(arch, reduced=True)
    H, KV, hd = rcfg.num_heads, rcfg.num_kv_heads, rcfg.head_dim
    pcfg = dataclasses.replace(rcfg, attn_shard="pad_heads",
                               attn_pad_to=2 * H)
    cfg = port_configs.get_config(arch, reduced=True)
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) * 3
               for h in (H, KV, KV))
    pos = np.arange(S, dtype=np.int32)
    want = ref_attention.attend(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(pos), pcfg, REF_RULES)
    got = attention.attend(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                           torch.as_tensor(pos), torch.as_tensor(pos), cfg,
                           None)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_reference_field_for_field(arch, reduced):
    want = dataclasses.asdict(ref_configs.get_config(arch, reduced=reduced))
    got = dataclasses.asdict(port_configs.get_config(arch, reduced=reduced))
    for f in ("dtype", "param_dtype"):
        got[f], want[f] = _dtype_name(got[f]), _dtype_name(want[f])
    assert got == want


def test_registry_names_match_reference():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert set(port_configs.ARCHS) == set(ref_configs.ARCHS)
    assert port_configs.SHAPES == {
        n: port_configs.ShapeCell(*dataclasses.astuple(c))
        for n, c in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_count_params_equal_reference_at_full_size(arch):
    """Shapes only: the full-size tree is ``meta`` tensors."""
    cfg = port_configs.get_config(arch)
    shapes = M.param_shapes(cfg)
    assert shapes["embed"].device.type == "meta"
    assert M.count_params(cfg) == RM.count_params(
        ref_configs.get_config(arch))


def test_internlm2_full_width_sizes():
    """The figures the chip run's bounds use: 1.889 B parameters, of which
    the embedding and the untied head 189.5 M each, 62.9 M a layer."""
    cfg = port_configs.get_config("internlm2-1.8b")
    shapes = M.param_shapes(cfg)
    assert M.count_params(cfg) == 1_889_110_016
    assert shapes["embed"].numel() == shapes["head"].numel() == 189_530_112
    per_layer = sum(t.numel() for t in shapes["layers"].values()) // 24
    assert per_layer == 62_918_656
    cache = M.make_cache(cfg, 8, 128, shapes_only=True)
    assert cache.k.device.type == "meta"
    assert 2 * cache.k.numel() * 2 == 100_663_296       # bf16 K and V bytes


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip(pair, dtype):
    """``params_from_reference`` of ``params_to_reference`` is the
    identity, with bf16 or float32 arrays between (bf16 -> f32 -> bf16 is
    exact)."""
    rcfg, params, cfg, model = pair
    tree = params_to_reference(model, dtype=jnp.bfloat16
                               if dtype == "bfloat16" else None)
    leaves = jax.tree.leaves(tree)
    assert {a.dtype.name for a in leaves} == {dtype}
    if dtype == "bfloat16":
        for a, b in zip(leaves, jax.tree.leaves(params)):
            np.testing.assert_array_equal(a.view(np.int16),
                                          np.asarray(b).view(np.int16))
    back = params_from_reference(tree, cfg, device="cpu")
    for (n, a), (m, b) in zip(_named(model), _named(back)):
        assert n == m and a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b), n


def test_init_params_draws_the_reference_scales():
    """The port's own init (a torch generator) keeps the reference's
    distribution: std = 1/sqrt(shape[0]) of the stacked layout, norms
    zero, bf16; the same seed gives the same weights."""
    cfg = port_configs.get_config("internlm2-1.8b", reduced=True)
    a = M.init_params(cfg, 0, device="cpu")
    b = M.init_params(cfg, 0, device="cpu")
    for (n, x), (_, y) in zip(_named(a), _named(b)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), n
    assert float(a["final_norm"].abs().max()) == 0.0
    # wq is stacked (G, P, D, H, hd) in the reference: fan_in = G = 2
    wq = a["layers"]["wq"].float()
    assert abs(float(wq.std()) - 2 ** -0.5) < 0.02
    assert abs(float(a["embed"].float().std())
               - cfg.vocab_size ** -0.5) < 2e-3
    assert not torch.equal(a["embed"],
                           M.init_params(cfg, 1, device="cpu")["embed"])


def test_default_device_is_the_card(monkeypatch):
    """Every public builder of the model package allocates on the card
    unless told otherwise, and raises without one; ``cache_shapes`` and
    ``param_shapes`` allocate nothing."""
    from repro_torch.models import attention as port_attention
    from repro_torch.models.common import InitBuilder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_configs.get_config("internlm2-1.8b", reduced=True)
    for call in (lambda: M.init_params(cfg, 0),
                 lambda: M.make_cache(cfg, 2, 16),
                 lambda: InitBuilder(0, torch.bfloat16),
                 lambda: port_attention.init_kv_cache(2, 2, 16, cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert port_attention.cache_shapes(2, 2, 16, cfg).k.device.type == "meta"
    assert M.make_cache(cfg, 2, 16, shapes_only=True).v.is_meta
    assert InitBuilder(0, torch.bfloat16, device="cpu")(
        "w", (4, 3), (None, None)).device.type == "cpu"


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_param_shapes_equal_reference_for_every_arch(arch):
    """Every family's tree at full size: the paths and shapes of
    ``param_shapes`` are the reference's, as ``meta`` tensors, and so is
    ``count_params``."""
    cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    shapes = M.param_shapes(cfg)
    assert all(t.device.type == "meta" for _, t in _named(shapes))
    ref = jax.tree_util.tree_flatten_with_path(RM.param_shapes(rcfg))[0]
    assert [(n, tuple(t.shape)) for n, t in tree_items(shapes)] == [
        (jax.tree_util.keystr(p), s.shape) for p, s in ref]
    assert M.count_params(cfg) == RM.count_params(rcfg)

