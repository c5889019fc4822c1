"""The tensor-parallel pieces of ``repro_torch.models.common`` (the
counterpart of the reference's ``shard`` constraints) on two gloo CPU
ranks, each holding its half of a vocab or of ``d_ff``, against the same
functions on the whole tensors in one process.

One module fixture starts two ranks (a ``file://`` store, no TCP port)
that run every case under ``common.tensor_parallel`` over a ``("model",)``
mesh of two and write their results to a pickle file; the test process
computes the whole-tensor side and the reference's ``_xent``.

Held:

* the vocab-parallel cross-entropy (``models._xent`` through
  ``common.vocab_nll``), with and without a mask, value and gradient,
  against ``_xent`` on the whole vocab: within 1e-12 (relative) in
  float64 (measured: the loss equal, the gradient 7e-16); in fp32 within
  1e-6 of it and of the reference's ``_xent`` (``jax.value_and_grad``;
  measured: losses 0 and 1.1e-7, gradients 2.2e-7 and 1.8e-7, a few fp32
  ulps of the largest entry);
* the embedding lookup (ids on both sides of the split, the table's
  gradient): equal to the whole lookup, bit for bit, in float64 and bf16;
* the next-token argmax (``common.vocab_argmax``) equal to
  ``torch.argmax`` on the whole row, with ties planted across the ranks,
  within a rank, at the split's edges and at a row's first and last
  index;
* ``glu_mlp`` and ``plain_mlp`` with ``d_ff`` split against the whole
  products: output and the gradients of the input and the three (two)
  weights within 1e-12 (relative) in float64; in bf16 within 2e-2 of the
  whole bf16 function (relative to the largest entry; measured: 4.2e-3
  the outputs, 3.3e-3 the input's gradient, the weights' gradients
  equal), about as far as each of them parts from the float64 function
  (3.3e-3 to 9.0e-3).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest
import torch

WORLD = 2
TIMEOUT = 120
V, D, F = 64, 8, 12
# the attention cases: reduced internlm2 at these widths (D = 8, 2 x 6
# tokens); padded heads Hp > H with a rank holding one real head and two
# padded (pad6), and with rank 1 holding padding alone (pad_gemma: KV = 1,
# H = 4, Hp = 8, as gemma-2b's 8 of 16); the head dim split in two
ATTN = {"pad6": dict(d_model=D, num_heads=4, num_kv_heads=2, head_dim=4,
                     attn_shard="pad_heads", attn_pad_to=6),
        "pad_gemma": dict(d_model=D, num_heads=4, num_kv_heads=1,
                          head_dim=4, attn_shard="pad_heads", attn_pad_to=8),
        "head_dim": dict(d_model=D, num_heads=4, num_kv_heads=2, head_dim=8,
                         attn_shard="head_dim")}

_RANK = textwrap.dedent("""
    import datetime, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    OUT, RANK, WORLD = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                            rank=RANK, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=100))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import models as M
    from repro_torch.distributed.sharded import AxisComm
    from repro_torch.models.common import (TensorParallel, embed_tokens,
                                           glu_mlp, plain_mlp,
                                           tensor_parallel, vocab_argmax)
    from repro_torch.launch import RULES

    IN = dict(np.load(os.path.join(OUT, "inputs.npz")))
    ATTN = @ATTN@
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    comm = AxisComm(mesh, ("model",))
    TP = TensorParallel(comm, mlp=True, vocab=True)

    def half(a, dim):
        n = a.shape[dim] // WORLD
        return a.narrow(dim, RANK * n, n)

    def summed(g):
        # the gradient of a leaf each rank took its half of (zero outside)
        return comm.sum(g)

    def leaf(a, dtype):
        return torch.tensor(a, dtype=dtype).requires_grad_()

    out = {}
    for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for masked in (False, True):
            logits = leaf(IN["logits"], dt)
            mask = torch.tensor(IN["mask"]) if masked else None
            with tensor_parallel(TP):
                loss = M._xent(half(logits, -1), torch.tensor(IN["labels"]),
                               mask)
            g, = torch.autograd.grad(loss, logits)
            out[f"xent_{name}_{masked}"] = (loss.item(),
                                            summed(g).double().numpy())
    for name, dt in (("f64", torch.float64), ("bf16", torch.bfloat16)):
        table = leaf(IN["table"], dt)
        with tensor_parallel(TP):
            x = embed_tokens(torch.tensor(IN["tokens"]), half(table, 0),
                             RULES, dtype=dt)
        g, = torch.autograd.grad(x, table,
                                 torch.tensor(IN["cot_embed"], dtype=dt))
        out[f"embed_{name}"] = (x.detach().double().numpy(),
                                summed(g).double().numpy())
        ws = [leaf(IN[k], dt) for k in ("x", "w_gate", "w_up", "w_down")]
        x, wg, wu, wd = ws
        with tensor_parallel(TP):
            y = glu_mlp(x, half(wg, 1), half(wu, 1), half(wd, 0), "silu",
                        RULES)
        gs = torch.autograd.grad(y, ws, torch.tensor(IN["cot_mlp"],
                                                     dtype=dt))
        out[f"glu_{name}"] = [t.detach().double().numpy() for t in (
            y, gs[0], *map(summed, gs[1:]))]
        ws = [leaf(IN[k], dt) for k in ("x", "w_up", "w_down")]
        x, wu, wd = ws
        with tensor_parallel(TP):
            y = plain_mlp(x, half(wu, 1), half(wd, 0), "gelu", RULES)
        gs = torch.autograd.grad(y, ws, torch.tensor(IN["cot_mlp"],
                                                     dtype=dt))
        out[f"plain_{name}"] = [t.detach().double().numpy() for t in (
            y, gs[0], *map(summed, gs[1:]))]
    ties = torch.tensor(IN["ties"])
    out["argmax"] = vocab_argmax(half(ties, -1), comm).numpy()

    # attention: qkv_project -> attend -> out_project, the weights whole
    # (pad_heads) or split on the head dim (head_dim)
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.distributed import sharded

    def attn(kind, dt, tp_on=True):
        cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True),
                                  **ATTN[kind], dtype=dt, param_dtype=dt)
        ws = [leaf(IN[f"{kind}_{k}"], dt) for k in ("x", "wq", "wk", "wv",
                                                    "wo")]
        x, wq, wk, wv, wo = ws
        split = cfg.attn_shard == "head_dim"
        if split:
            wq, wk, wv, wo = (half(wq, -1), half(wk, -1), half(wv, -1),
                              half(wo, -2))
        pos = torch.arange(x.shape[1], dtype=torch.int32)
        tp = TensorParallel(comm, head_dim=split, pad_heads=not split)
        with tensor_parallel(tp if tp_on else None):
            q, k, v = A.qkv_project(x, wq, wk, wv, cfg, RULES, pos)
            ctx = A.attend(q, k, v, pos, pos, cfg, RULES)
            y = A.out_project(ctx, wo, RULES)
        gs = torch.autograd.grad(y, ws, torch.tensor(IN[f"{kind}_cot"],
                                                     dtype=dt))
        gs = [gs[0], *(map(summed, gs[1:]) if split else gs[1:])]
        return [t.detach().double().numpy() for t in (y, *gs)]

    for kind in ATTN:
        for name, dt in (("f64", torch.float64), ("bf16", torch.bfloat16)):
            sharded.reset()
            out[f"attn_{kind}_{name}"] = attn(kind, dt)
            out[f"attn_{kind}_{name}_bytes"] = dict(sharded.BYTES)
    # planted faults, float64: RoPE on the local columns alone; the
    # probabilities without their CopyToGroup; the padded heads'
    # gradient left partial (SplitToGroup's backward without its gather)
    rope_cols = A._rope_cols
    A._rope_cols = lambda x, positions, theta, angles, comm: A.rope(
        x, positions, theta)
    try:
        out["fault_rope"] = attn("head_dim", torch.float64)
    finally:
        A._rope_cols = rope_cols
    copy = A.tp_copy
    A.tp_copy = lambda x, part: x if x.ndim == 5 else copy(x, part)
    try:
        out["fault_probs"] = attn("head_dim", torch.float64)
    finally:
        A.tp_copy = copy
    split_bwd = sharded.SplitToGroup.backward

    def partial(ctx, g):
        comm_, dim, n = ctx.args
        per = g.shape[dim]
        whole = torch.cat([g.new_zeros(g.shape)] * comm_.size, dim)
        whole.narrow(dim, comm_.rank * per, per).copy_(g)
        return whole.narrow(dim, 0, n), None, None, None
    sharded.SplitToGroup.backward = staticmethod(partial)
    try:
        out["fault_partial"] = attn("pad_gemma", torch.float64)
    finally:
        sharded.SplitToGroup.backward = split_bwd
    with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _ties():
    """Rows of logits with the maximum planted: on both ranks (first index
    on rank 0), twice on rank 1 only, at the split's edges (31 | 32), at
    the row's first and last entries, at every entry, and one row with a
    unique maximum on rank 1."""
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(8, V)).astype(np.float32)
    top = np.float32(10.0)
    for row, idx in enumerate([(5, 40), (33, 60), (31, 32), (0, V - 1),
                               (32, 0), (63,), tuple(range(V)), (47,)]):
        rows[row, list(idx)] = top
    return rows


def _inputs(path):
    rng = np.random.default_rng(0)
    B, S = 3, 5
    tokens = rng.integers(0, V, (B, S))
    tokens[0, :4] = [0, V // 2 - 1, V // 2, V - 1]        # both sides
    np.savez(path,
             logits=rng.normal(scale=3.0, size=(B, S, V)),
             labels=rng.integers(0, V, (B, S)).astype(np.int32),
             mask=(rng.random((B, S)) < 0.6),
             table=rng.normal(size=(V, D)), tokens=tokens.astype(np.int32),
             cot_embed=rng.normal(size=(B, S, D)),
             x=rng.normal(size=(B, S, D)),
             w_gate=rng.normal(scale=0.4, size=(D, F)),
             w_up=rng.normal(scale=0.4, size=(D, F)),
             w_down=rng.normal(scale=0.4, size=(F, D)),
             cot_mlp=rng.normal(size=(B, S, D)), ties=_ties(),
             **_attn_inputs(rng))


def _attn_inputs(rng, B=2, S=6):
    out = {}
    for kind, kw in ATTN.items():
        H, KV, hd = kw["num_heads"], kw["num_kv_heads"], kw["head_dim"]
        for name, shape in (("x", (B, S, D)), ("wq", (D, H, hd)),
                            ("wk", (D, KV, hd)), ("wv", (D, KV, hd)),
                            ("wo", (H, hd, D)), ("cot", (B, S, D))):
            scale = 1.0 if name in ("x", "cot") else D ** -0.5
            out[f"{kind}_{name}"] = rng.normal(scale=scale, size=shape)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    _inputs(out / "inputs.npz")
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK.replace("@ATTN@", repr(ATTN)),
         str(out), str(r), str(WORLD),
         str(out / "store")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            assert p.returncode == 0, f"a rank exited {p.returncode}:\n{se}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    got[0]["rank1"] = got[1]
    return got[0], dict(np.load(out / "inputs.npz"))


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def _whole_xent(inputs, dtype, masked):
    from repro_torch import models as M
    logits = torch.tensor(inputs["logits"], dtype=dtype).requires_grad_()
    mask = torch.tensor(inputs["mask"]) if masked else None
    loss = M._xent(logits, torch.tensor(inputs["labels"]), mask)
    g, = torch.autograd.grad(loss, logits)
    return loss.item(), g.double().numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_xent_float64(runs, masked):
    got, inputs = runs
    loss, grad = got[f"xent_f64_{masked}"]
    want_loss, want_grad = _whole_xent(inputs, torch.float64, masked)
    assert abs(loss - want_loss) <= 1e-12 * abs(want_loss), (loss, want_loss)
    assert _rel(grad, want_grad) <= 1e-12, _rel(grad, want_grad)


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_xent_fp32_against_the_reference(runs, masked):
    import jax
    import jax.numpy as jnp
    from repro.models import _xent
    got, inputs = runs
    loss, grad = got[f"xent_f32_{masked}"]
    want_loss, want_grad = _whole_xent(inputs, torch.float32, masked)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    assert _rel(grad, want_grad) <= 1e-6, _rel(grad, want_grad)
    mask = jnp.asarray(inputs["mask"]) if masked else None
    rl, rg = jax.value_and_grad(lambda l: _xent(
        l, jnp.asarray(inputs["labels"]), mask))(
        jnp.asarray(inputs["logits"], jnp.float32))
    assert abs(loss - float(rl)) <= 1e-6 * abs(float(rl))
    assert _rel(grad, np.asarray(rg, np.float64)) <= 1e-6


@pytest.mark.parametrize("dtype", ["f64", "bf16"])
def test_vocab_parallel_embedding(runs, dtype):
    from repro_torch.launch import RULES
    from repro_torch.models.common import embed_tokens
    got, inputs = runs
    dt = {"f64": torch.float64, "bf16": torch.bfloat16}[dtype]
    table = torch.tensor(inputs["table"], dtype=dt).requires_grad_()
    x = embed_tokens(torch.tensor(inputs["tokens"]), table, RULES, dtype=dt)
    g, = torch.autograd.grad(x, table, torch.tensor(inputs["cot_embed"],
                                                    dtype=dt))
    have_x, have_g = got[f"embed_{dtype}"]
    np.testing.assert_array_equal(have_x, x.detach().double().numpy())
    np.testing.assert_array_equal(have_g, g.double().numpy())


def test_vocab_argmax_takes_the_first_global_index(runs):
    got, inputs = runs
    want = torch.argmax(torch.tensor(inputs["ties"]), dim=-1).numpy()
    assert want.tolist() == [5, 33, 31, 0, 0, 63, 0, 47]
    np.testing.assert_array_equal(got["argmax"], want)


def _whole_mlp(inputs, kind, dtype):
    from repro_torch.launch import RULES
    from repro_torch.models.common import glu_mlp, plain_mlp
    names = (("x", "w_gate", "w_up", "w_down") if kind == "glu"
             else ("x", "w_up", "w_down"))
    ws = [torch.tensor(inputs[k], dtype=dtype).requires_grad_()
          for k in names]
    y = (glu_mlp(*ws, "silu", RULES) if kind == "glu"
         else plain_mlp(*ws, "gelu", RULES))
    gs = torch.autograd.grad(y, ws, torch.tensor(inputs["cot_mlp"],
                                                 dtype=dtype))
    return [t.detach().double().numpy() for t in (y, *gs)]


@pytest.mark.parametrize("kind", ["glu", "plain"])
def test_split_mlp_float64(runs, kind):
    got, inputs = runs
    for have, want in zip(got[f"{kind}_f64"],
                          _whole_mlp(inputs, kind, torch.float64)):
        assert _rel(have, want) <= 1e-12, _rel(have, want)


@pytest.mark.parametrize("kind", ["glu", "plain"])
def test_split_mlp_bf16(runs, kind):
    got, inputs = runs
    whole = _whole_mlp(inputs, kind, torch.bfloat16)
    truth = _whole_mlp(inputs, kind, torch.float64)
    for i, (have, want, exact) in enumerate(zip(got[f"{kind}_bf16"], whole,
                                                truth)):
        err = _rel(have, want)
        print(f"{kind} output/grad {i}: split vs whole bf16 {err:.2e}, "
              f"split vs float64 {_rel(have, exact):.2e}, whole vs "
              f"float64 {_rel(want, exact):.2e}")
        assert err <= 2e-2, (kind, i, err)


def _whole_attn(inputs, kind, dtype):
    """qkv_project -> attend -> out_project on the whole weights in one
    process: output and the gradients of x, wq, wk, wv and wo."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import RULES
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True),
                              **ATTN[kind], dtype=dtype, param_dtype=dtype)
    ws = [torch.tensor(inputs[f"{kind}_{k}"], dtype=dtype).requires_grad_()
          for k in ("x", "wq", "wk", "wv", "wo")]
    x, wq, wk, wv, wo = ws
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    q, k, v = A.qkv_project(x, wq, wk, wv, cfg, RULES, pos)
    y = A.out_project(A.attend(q, k, v, pos, pos, cfg, RULES), wo, RULES)
    gs = torch.autograd.grad(y, ws, torch.tensor(inputs[f"{kind}_cot"],
                                                 dtype=dtype))
    return [t.detach().double().numpy() for t in (y, *gs)]


@pytest.mark.parametrize("kind", list(ATTN))
def test_split_attention_float64(runs, kind):
    """``pad_heads`` (Hp > H; a rank of padding alone in ``pad_gemma``)
    and ``head_dim`` attention on two ranks: the output and the gradients
    of the input and every weight within 1e-12 (relative) of the whole
    function's."""
    got, inputs = runs
    names = ("out", "x", "wq", "wk", "wv", "wo")
    for name, have, want in zip(names, got[f"attn_{kind}_f64"],
                                _whole_attn(inputs, kind, torch.float64)):
        assert _rel(have, want) <= 1e-12, (kind, name, _rel(have, want))


@pytest.mark.parametrize("kind", list(ATTN))
def test_split_attention_bf16(runs, kind):
    got, inputs = runs
    whole = _whole_attn(inputs, kind, torch.bfloat16)
    truth = _whole_attn(inputs, kind, torch.float64)
    names = ("out", "x", "wq", "wk", "wv", "wo")
    for name, have, want, exact in zip(names, got[f"attn_{kind}_bf16"],
                                       whole, truth):
        err = _rel(have, want)
        print(f"{kind} {name}: split vs whole bf16 {err:.2e}, split vs "
              f"float64 {_rel(have, exact):.2e}, whole vs float64 "
              f"{_rel(want, exact):.2e}")
        assert err <= 2e-2, (kind, name, err)


@pytest.mark.parametrize("kind", ["pad6", "pad_gemma"])
def test_padded_heads_replicated_leaves_equal_on_every_rank(runs, kind):
    """Under ``pad_heads`` no weight is split over ``model``: both ranks'
    gradients of x, ``wq``, ``wk``, ``wv`` and ``wo`` are whole and equal
    (``reduce_grad`` takes each rank's as the leaf's), bit for bit."""
    got, _ = runs
    for dt in ("f64", "bf16"):
        mine, theirs = got[f"attn_{kind}_{dt}"], got["rank1"][
            f"attn_{kind}_{dt}"]
        for i, (a, b) in enumerate(zip(mine, theirs)):
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} {dt} {i}")


def test_padded_heads_collectives(runs):
    """The padded heads move what the reference's compiled step moves
    (see ``models/attention.py``): pad6 re-splits one head of the context
    point to point (H = 4 held 3 + 1, wanted 2 + 2), rank 0 sending it
    forward and rank 1 its cotangent backward; pad_gemma two (4 + 0 held);
    both all-gather the q and ``wo`` blocks' cotangents.  The head-dim
    split sends each rank's q and k columns to its partner and their
    cotangents back."""
    got, _ = runs
    B, S = 2, 6
    for rank in (got, got["rank1"]):
        for kind, heads in (("pad6", 1), ("pad_gemma", 2)):
            hd = ATTN[kind]["head_dim"]
            moved = rank[f"attn_{kind}_f64_bytes"]
            assert moved["collective_permute"] == heads * B * S * hd * 8, (
                kind, moved)
            assert moved["all_gather"] > 0, (kind, moved)
        moved = rank["attn_head_dim_f64_bytes"]
        c = ATTN["head_dim"]["head_dim"] // WORLD
        H, KV = (ATTN["head_dim"]["num_heads"],
                 ATTN["head_dim"]["num_kv_heads"])
        assert moved["collective_permute"] == 2 * (H + KV) * B * S * c * 8, (
            moved)
        assert moved["all_reduce"] > 0 and "all_gather" not in moved, moved


@pytest.mark.parametrize("fault", ["fault_rope", "fault_probs",
                                   "fault_partial"])
def test_attention_planted_faults_read_far_off(runs, fault):
    """RoPE on the local columns alone, the probabilities' cotangent left
    partial (no ``CopyToGroup``) and the padded heads' gradient left
    partial (``SplitToGroup``'s backward without its gather) each part the
    output or a gradient from the whole function's by more than 1e-3."""
    got, inputs = runs
    kind = "pad_gemma" if fault == "fault_partial" else "head_dim"
    worst = max(_rel(have, want) for have, want in zip(
        got[fault], _whole_attn(inputs, kind, torch.float64)))
    assert worst > 1e-3, (fault, worst)
