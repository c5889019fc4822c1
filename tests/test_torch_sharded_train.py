"""The sharded training step (``train.step`` on DTensor params and state,
``distributed.sharded``, the MoE layer's expert-parallel branch) on four
gloo CPU ranks, against the reference's sharded step on a 4-device CPU
mesh and against the port's own one-rank step; sharded checkpoints; the
multi-rank launcher.

One module fixture starts, together: four gloo ranks (a ``file://``
store, no TCP port) that run every case; one reference subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, a mesh of
``AxisType.Auto`` axes, ``jax.jit`` with ``in_shardings`` from
``named(mesh, specs)`` as ``tests/test_hlo_quality.py`` builds them,
each step compiled once); and the training launcher on four ranks.  All
read the same seeded numpy params (N(0, 0.05), norms zero) and batches
(8 x 32 tokens, 2 steps, lr 1e-3).  Cases: granite-moe reduced on a
(2, 2) ``("data", "model")`` mesh with AdamW and with
Adafactor(beta1=0.9), internlm2 reduced on (2, 2) and (4, 1) with AdamW
(on (2, 2) its ``head_dim`` attention split on the head dim, the MLPs
and the vocab tensor-parallel), internlm2 reduced under
``attn_shard="heads"`` on (2, 2) (H = 4 and KV = 2 divide the two
``model`` ranks: the attention head-parallel too) and under
``attn_shard="pad_heads"`` with ``attn_pad_to=6`` (3 padded heads a
``model`` rank, rank 1 holding one real head), and granite-moe with
AdamW, ``accum_steps=2`` on both sides and capacity factor 0.5, at which
every MoE dispatch drops assignments (printed).  On (2, 2) the port's
step computes tensor-parallel over ``model`` (``common.tensor_parallel``);
on (4, 1) the axis has one rank and the step runs the one-device code.  A
sixth process runs the dry run (``launch.dryrun``) of the granite AdamW
case on ``meta`` tensors over a fake group of four.

Held:

* against the reference's sharded step, in bf16: loss, ``grad_norm``
  and the updated params' mean distance, each within 4 times the
  reference's own distance between its sharded and its one-device step,
  or a floor (see ``_tol``): both sharded steps are the same function in
  bf16 with sums in other orders, so they may part as far as the
  reference parts from itself; each param entry within twice the
  largest change the steps made to its leaf (a normalized update may
  flip its sign where the gradient is near 0);
* against the port's one-rank step in float64: the loss of both steps
  and the step-0 gradient leaf by leaf within 1e-10; the one-rank side
  takes the mean of the gradients of each data shard's rows (a MoE
  layer's capacity counts the shard's own tokens, as the reference's
  ``shard_map`` body does), with accumulation of each block the
  reference's micro-batches give a data shard.  The optimizers keep an fp32 state, so the
  updated params agree to fp32 roundings (8 fp32 ulps of the leaf's
  largest entry);
* the planted faults read above 1e-3: the MoE copy's backward without
  its all-reduce over ``model``, and no gradient sum over ``data``
  (granite-moe); the MLP's row product without its ``ReduceFromGroup``
  and ``CopyToGroup``'s backward without its all-reduce (internlm2);
* a rank's all-gather bytes of a step fall, from every leaf gathered to
  the tensor-parallel leaves kept, by exactly those leaves' whole bytes
  (the attention's among them under ``head_dim`` and ``heads``);
* every rank's local shapes are its specs' shards, ``init_state``
  equals the full state placed by ``distribute``, and a dim split over
  ``("pod", "data")`` gives each mesh position JAX's rows;
* a state saved on the four ranks restores on two and on one, leaf for
  leaf; the launcher run on four ranks and resumed at step 2 ends in the
  state of the uninterrupted run, bit for bit;
* the dry run's collective bytes of a step and shard bytes equal each
  rank's, to the byte;
* the reference's fault: under ``jax.make_mesh``'s default (Explicit)
  axes its granite-moe step raises ``ShardingTypeError``.
"""
import os
import pickle
import re
import shutil
import socket
import subprocess
import sys
import textwrap
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest

WORLD = 4
SPAWN_TIMEOUT = 600
STEPS = 2
LR = 1e-3
# name: (arch, mesh shape, optimizer, accum_steps, config overrides)
CASES = {"granite_adamw_2x2": ("granite-moe-1b-a400m", (2, 2), "adamw", 1,
                               {}),
         "granite_adafactor_2x2": ("granite-moe-1b-a400m", (2, 2),
                                   "adafactor", 1, {}),
         # head_dim attention: the MLPs and the vocab tensor-parallel
         "internlm2_adamw_2x2": ("internlm2-1.8b", (2, 2), "adamw", 1, {}),
         "internlm2_adamw_4x1": ("internlm2-1.8b", (4, 1), "adamw", 1, {}),
         # H = 4 and KV = 2 divide the 2 model ranks: the attention heads
         # tensor-parallel too
         "internlm2_heads_2x2": ("internlm2-1.8b", (2, 2), "adamw", 1,
                                 {"attn_shard": "heads"}),
         # the padded heads: 6 of them, 3 a model rank, rank 1 holding one
         # real head and two padded
         "internlm2_pad6_2x2": ("internlm2-1.8b", (2, 2), "adamw", 1,
                                {"attn_shard": "pad_heads",
                                 "attn_pad_to": 6}),
         # micro-batches of capacity-bound MoE layers: every data shard's
         # micro-batch of 2 x 32 tokens sends 128 assignments to 4 experts
         # of capacity 16, so the layers drop
         "granite_adamw_2x2_accum2": ("granite-moe-1b-a400m", (2, 2),
                                      "adamw", 2, {"capacity_factor": 0.5})}
# the cases whose all-gather bytes are held with and without the
# tensor-parallel leaves kept
KEPT = ("granite_adamw_2x2", "internlm2_adamw_2x2", "internlm2_heads_2x2")
ARCHS = sorted({c[0] for c in CASES.values()})

_COMMON = textwrap.dedent("""
    import os, pickle, re, sys
    import numpy as np
    OUT = sys.argv[1]
    CASES = @CASES@
    KEPT = @KEPT@
    INPUTS = dict(np.load(os.path.join(OUT, "inputs.npz")))

    def nested(prefix):
        tree = {}
        for key, a in INPUTS.items():
            if key.startswith(prefix + "|"):
                *path, last = re.findall(r"\\['([^']+)'\\]",
                                         key.split("|", 1)[1])
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = a
        return tree

    def batch(arch, i):
        head = f"batch|{arch}|{i}|"
        return {k[len(head):]: a for k, a in INPUTS.items()
                if k.startswith(head)}

    def dump(name, obj):
        with open(os.path.join(OUT, name + ".pkl"), "wb") as f:
            pickle.dump(obj, f)
""")

_RANK = _COMMON + textwrap.dedent("""
    import dataclasses, datetime, traceback
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    RANK, WORLD = int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                            rank=RANK, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=480))
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import interop, models as M
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharded
    from repro_torch.launch import RULES
    from repro_torch.launch.sharding import (distribute, init_state, named,
                                             rules_for)
    from repro_torch.models import common, moe
    from repro_torch.models.common import P, set_current_mesh
    from repro_torch.train import step as step_mod
    from repro_torch.train import Adafactor, AdamW, make_train_step
    from repro_torch.train.step import (_value_and_grad, make_loss,
                                        sharded_value_and_grad)
    from repro_torch.tree import tree_items, tree_map

    F64 = torch.float64

    def make_opt(name):
        return AdamW() if name == "adamw" else Adafactor(beta1=0.9)

    def configs(arch, kw):
        cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
        return {"bf16": cfg, "f64": dataclasses.replace(
            cfg, dtype=F64, param_dtype=F64)}

    def params(arch, cfg):
        p = interop.params_from_reference(nested(arch), cfg, device="cpu")
        return p if cfg.dtype != F64 else tree_map(lambda t: t.to(F64), p)

    def tbatch(arch, i):
        return {k: torch.as_tensor(v) for k, v in batch(arch, i).items()}

    def whole(tree):
        return {k: sharded.gather(v).double().numpy()
                for k, v in tree_items(tree)}

    def state_items(st):
        return {f"{f}{k}": v for f in st._fields
                for k, v in tree_items(getattr(st, f))}

    def shards_of_specs(leaf, spec, mesh):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out = list(leaf.shape)
        for d, e in enumerate(spec):
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                out[d] //= sizes[a]
        return out

    def one_rank(arch, cfg, opt, n_data, accum):
        # the port's one-device step on the mean of the gradients of the
        # reference's blocks, in float64: micro-batch m holds the global
        # rows m B/a .. (m + 1) B/a (the reference reshapes the batch), and
        # data shard j of it the j-th of their n_data blocks
        set_current_mesh(None)
        p = params(arch, cfg)
        st = opt.init(p)
        loss_fn = make_loss(cfg, RULES)
        losses, g0 = [], None
        for i in range(STEPS):
            b = tbatch(arch, i)
            per = next(iter(b.values())).shape[0] // (accum * n_data)
            parts = [_value_and_grad(loss_fn, p, {
                k: v[(m * n_data + j) * per:(m * n_data + j + 1) * per]
                for k, v in b.items()})
                for m in range(accum) for j in range(n_data)]
            n = len(parts)
            losses.append(float(sum(l for l, _ in parts) / n))
            grads = tree_map(lambda *gs: sum(gs) / n,
                             *[g for _, g in parts])
            if i == 0:
                g0 = {k: v.numpy() for k, v in tree_items(grads)}
            p, st = opt.update(grads, st, p, torch.tensor(LR))
        return {"losses": losses, "grads0": g0,
                "params": {k: v.numpy() for k, v in tree_items(p)}}

    def sharded_grads(arch, cfg, rules, mesh, accum=1):
        sp = distribute(params(arch, cfg), mesh, M.param_specs(cfg, rules))
        _, g = sharded_value_and_grad(make_loss(cfg, rules), sp,
                                      tbatch(arch, 0), rules, accum)
        return {k: sharded.gather(DTensor.from_local(
            gl, v.device_mesh, v.placements, run_check=False, shape=v.shape,
            stride=v.stride())).numpy()
            for (k, v), (_, gl) in zip(tree_items(sp), tree_items(g))}

    def tp_faults(arch, cfg, rules, mesh):
        # the MLP's row product without its sum over the model ranks, and
        # the copy's backward without its all-reduce
        out = {}
        tp_sum = common.tp_sum
        common.tp_sum = lambda y, part: (y if part == "mlp"
                                         else tp_sum(y, part))
        try:
            out["fault_row"] = sharded_grads(arch, cfg, rules, mesh)
        finally:
            common.tp_sum = tp_sum
        copy_bwd = sharded.CopyToGroup.backward
        sharded.CopyToGroup.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            out["fault_tp_copy"] = sharded_grads(arch, cfg, rules, mesh)
        finally:
            sharded.CopyToGroup.backward = copy_bwd
        return out

    def gather_bytes(arch, cfg, rules, mesh):
        # the all-gather bytes of the step's gradient, with the
        # tensor-parallel leaves kept and with every leaf gathered
        out = {}
        tp_of = step_mod.tensor_parallel_of
        for key, fn in (("kept", tp_of), ("gathered", lambda *a: None)):
            step_mod.tensor_parallel_of = fn
            try:
                sp = distribute(params(arch, cfg), mesh,
                                M.param_specs(cfg, rules))
                sharded.reset()
                sharded_value_and_grad(make_loss(cfg, rules), sp,
                                       tbatch(arch, 0), rules)
                out[key] = sharded.BYTES["all_gather"]
            finally:
                step_mod.tensor_parallel_of = tp_of
        return out

    DROPS = []

    def counted(fn):
        # the MoE dispatch, recording the assignments it drops a call
        def dispatch(xf, logits, E_range, cfg):
            buf, meta = fn(xf, logits, E_range, cfg)
            e0, e_loc = E_range
            top = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)[1] - e0
            local = int(((top >= 0) & (top < e_loc)).sum())
            DROPS.append(local - int(meta[0].sum()))
            return buf, meta
        return dispatch

    moe._dispatch_local = counted(moe._dispatch_local)

    def run_case(name, arch, shape, optname, accum, kw):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        set_current_mesh(mesh)
        rec = {}
        for dt, cfg in configs(arch, kw).items():
            rules = rules_for(cfg, SHAPES["train_4k"], mesh)
            opt = make_opt(optname)
            specs = M.param_specs(cfg, rules)
            full = params(arch, cfg)
            sp = distribute(full, mesh, specs)
            st = init_state(opt, sp, specs)
            if dt == "bf16":
                sspecs = opt.state_specs(specs)
                want = distribute(opt.init(full), mesh, sspecs)
                rec["init_state_equal"] = all(
                    torch.equal(a.to_local(), b.to_local())
                    for a, b in zip(state_items(st).values(),
                                    state_items(want).values()))
                bad = []
                for items, spec_items in (
                        (tree_items(sp), tree_items(specs)),
                        (state_items(st), state_items(sspecs))):
                    specd = dict(spec_items)
                    for k, v in dict(items).items():
                        if list(v.to_local().shape) != shards_of_specs(
                                v, specd[k], mesh):
                            bad.append((k, list(v.to_local().shape)))
                rec["bad_local_shapes"] = bad
                rec["n_leaves"] = len(tree_items(sp)) + len(state_items(st))
                rec["local_bytes"] = {
                    k: sum(v.to_local().numel() * v.element_size()
                           for v in leaves) for k, leaves in (
                        ("params", [v for _, v in tree_items(sp)]),
                        ("opt_state", list(state_items(st).values())))}
            if dt == "f64":
                rec["grads0"] = sharded_grads(arch, cfg, rules, mesh, accum)
                if arch.startswith("granite") and accum == 1:
                    copy_bwd = sharded.CopyToGroup.backward
                    sharded.CopyToGroup.backward = staticmethod(
                        lambda ctx, g: (g, None))
                    try:
                        rec["fault_copy"] = sharded_grads(arch, cfg, rules,
                                                          mesh)
                    finally:
                        sharded.CopyToGroup.backward = copy_bwd
                    reduce = sharded.reduce_grad
                    sharded.reduce_grad = (
                        lambda g, leaf, axes, keep=(): reduce(g, leaf, (),
                                                               keep))
                    try:
                        rec["fault_data"] = sharded_grads(arch, cfg, rules,
                                                          mesh)
                    finally:
                        sharded.reduce_grad = reduce
                if name == "internlm2_adamw_2x2":
                    rec.update(tp_faults(arch, cfg, rules, mesh))
            if dt == "bf16" and name in KEPT:
                rec["gather_bytes"] = gather_bytes(arch, cfg, rules, mesh)
            step = make_train_step(cfg, rules, opt, lambda s: LR,
                                   accum_steps=accum)
            ms = []
            for i in range(STEPS):
                sharded.reset()
                del DROPS[:]
                sp, st, m = step(sp, st, tbatch(arch, i), i)
                ms.append((float(m["loss"]), float(m["grad_norm"])))
                if i == 0:
                    # this rank's collective bytes and drops a call in
                    # step 0
                    rec[f"{dt}_bytes"] = dict(sharded.BYTES)
                    rec[f"{dt}_drops"] = list(DROPS)
            rec[dt] = {"metrics": ms, "params": whole(sp)}
            if dt == "f64" and RANK == 0:
                rec["one_rank"] = one_rank(arch, cfg, make_opt(optname),
                                           shape[0], accum)
                set_current_mesh(mesh)
            if dt == "bf16" and name == "granite_adamw_2x2":
                rec["ckpt"] = checkpoint(cfg, rules, opt, sp, st)
        set_current_mesh(None)
        return rec

    def checkpoint(cfg, rules, opt, sp, st):
        # saved on four ranks, restored on two ((1, 2)) and on one
        ckpt = os.path.join(OUT, "ckpt")
        mgr = CheckpointManager(ckpt)
        mgr.save(STEPS, (sp, st))
        full = (tree_map(sharded.gather, sp),
                type(st)(*(tree_map(sharded.gather, f) for f in st)))
        m2 = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                        mesh_dim_names=("data", "model"))
        out = {}
        if RANK < 2:
            r2 = rules_for(cfg, SHAPES["train_4k"], m2)
            specs = M.param_specs(cfg, r2)
            place = lambda tree: tree_map(lambda pl: (m2, pl), tree)
            shard = (place(named(m2, specs)),
                     type(st)(*(place(f) for f in named(
                         m2, opt.state_specs(specs)))))
            got = mgr.restore(STEPS, full, shardings=shard)
            flat = lambda s: list(tree_items(s[0])) + list(
                state_items(s[1]).items())
            out["two"] = all(torch.equal(sharded.gather(a), b)
                             for (_, a), (_, b) in zip(flat(got),
                                                       flat(full)))
            out["two_sharded"] = sum(
                v.to_local().numel() < v.numel() for _, v in flat(got))
            if RANK == 0:
                one = mgr.restore(STEPS, full)
                out["one"] = all(type(a) is torch.Tensor
                                 and torch.equal(a, b)
                                 for (_, a), (_, b) in zip(flat(one),
                                                           flat(full)))
        dist.barrier()
        return out

    def tuple_order():
        # a dim split over ('pod', 'data'): this rank's rows
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod",
                                                               "data"))
        x = torch.arange(24).reshape(8, 3)
        got = distribute({"x": x}, mesh, {"x": P(("pod", "data"), None)})
        return {"coord": tuple(mesh.get_coordinate()),
                "rows": (got["x"].to_local()[:, 0] // 3).tolist()}

    STEPS, LR = @STEPS@, @LR@
    record = {"tuple_order": tuple_order()}
    dump(f"rank{RANK}", record)
    for name, (arch, shape, optname, accum, kw) in CASES.items():
        try:
            record[name] = run_case(name, arch, shape, optname, accum, kw)
        except Exception:
            record[name] = {"error": traceback.format_exc()}
            raise
        finally:
            dump(f"rank{RANK}", record)
    dist.destroy_process_group()
""")

_REFERENCE = _COMMON + textwrap.dedent("""
    import dataclasses, traceback
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    import repro.models as M
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCell
    from repro.launch.sharding import batch_struct, named, rules_for
    from repro.launch.train import ShardingRules
    from repro.models.common import set_current_mesh
    from repro.train import Adafactor, AdamW, make_train_step

    STEPS, LR = @STEPS@, @LR@
    ONE = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                        vocab=None, experts=None, fsdp=None, head_dim=None,
                        state=None, act_heads=None)

    def params(arch, cfg):
        shapes = M.param_shapes(cfg)
        arrays = nested(arch)
        return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), arrays,
                            shapes)

    def jitted(cfg, opt, mesh, accum):
        cell = ShapeCell("train", "train", 32, 8)
        if mesh is None:
            set_current_mesh(None)
            return (jax.jit(make_train_step(cfg, ONE, opt, lambda s: LR,
                                            accum_steps=accum)),
                    lambda t: t, lambda t: t, lambda b: b)
        set_current_mesh(mesh)
        rules = rules_for(cfg, cell, mesh)
        ps = named(mesh, M.param_specs(cfg, rules))
        ss = named(mesh, opt.state_specs(M.param_specs(cfg, rules)))
        bs = named(mesh, batch_struct(cfg, cell, rules)[1])
        fn = jax.jit(make_train_step(cfg, rules, opt, lambda s: LR,
                                     accum_steps=accum),
                     in_shardings=(ps, ss, bs, NamedSharding(mesh, P())),
                     out_shardings=(ps, ss, None))
        put = lambda sh: (lambda t: jax.device_put(t, sh))
        return fn, put(ps), put(ss), put(bs)

    def run(arch, opt, mesh, accum=1, kw={}):
        cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
        fn, pp, ps, pb = jitted(cfg, opt, mesh, accum)
        p = pp(params(arch, cfg))
        st = ps(opt.init(p))
        ms = []
        for i in range(STEPS):
            p, st, m = fn(p, st, pb({k: jnp.asarray(v) for k, v in
                                     batch(arch, i).items()}), jnp.int32(i))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        flat = jax.tree_util.tree_flatten_with_path(p)[0]
        return {"metrics": ms,
                "params": {jax.tree_util.keystr(k): np.asarray(
                    v.astype(jnp.float32)) for k, v in flat}}

    # a dim split over ('pod', 'data'): each mesh position's rows
    mesh = jax.make_mesh((2, 2), ("pod", "data"),
                         axis_types=(AxisType.Auto,) * 2)
    placed = jax.device_put(np.arange(8), NamedSharding(mesh, P(("pod",
                                                                 "data"))))
    where = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    record = {"tuple_order": {where[sh.device]: np.asarray(sh.data).tolist()
                              for sh in placed.addressable_shards}}
    def job(key):
        name, which = key
        arch, shape, optname, accum, kw = CASES[name]
        opt = AdamW() if optname == "adamw" else Adafactor(beta1=0.9)
        mesh = (jax.make_mesh(shape, ("data", "model"),
                              axis_types=(AxisType.Auto,) * 2)
                if which == "sharded" else None)
        return run(arch, opt, mesh, accum, kw)

    # a MoE layer reads the current mesh (a global) when it is traced:
    # those steps one at a time, the others' programs compiled together
    from concurrent.futures import ThreadPoolExecutor
    keys = [(n, w) for n in CASES for w in ("sharded", "one")]
    moe = [k for k in keys
           if get_config(CASES[k[0]][0], reduced=True).num_experts > 0]
    rest = [k for k in keys if k not in moe]
    done = {k: job(k) for k in moe}
    with ThreadPoolExecutor(max(len(rest), 1)) as ex:
        done.update(zip(rest, ex.map(job, rest)))
    for name in CASES:
        record[name] = {w: done[(name, w)] for w in ("sharded", "one")}
    # jax.make_mesh's default axes (Explicit): the reference's step raises
    if any(c[0] == "granite-moe-1b-a400m" for c in CASES.values()):
        try:
            run("granite-moe-1b-a400m", AdamW(), jax.make_mesh(
                (2, 2), ("data", "model")))
            record["explicit"] = {"raised": None}
        except Exception as e:
            record["explicit"] = {"raised": type(e).__name__,
                                  "message": str(e)[:400]}
    dump("reference" + (sys.argv[2] if len(sys.argv) > 2 else ""), record)
""")


_DRYRUN = _COMMON + textwrap.dedent("""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    # the granite case's step on meta tensors over a fake group of four
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
        trace, _ = dryrun.lower_config(
            get_config("granite-moe-1b-a400m", reduced=True),
            ShapeCell("train", "train", 32, 8), mesh)
    info = dryrun.analyze(trace)
    dump("dryrun", {k: info[k] for k in ("collective_bytes_per_device",
                                         "argument_bytes_by_tree")})
""")


def _script(text, cases=None, kept=None):
    return (text.replace("@CASES@", repr(CASES if cases is None else cases))
            .replace("@KEPT@", repr(KEPT if kept is None else kept))
            .replace("@STEPS@", repr(STEPS)).replace("@LR@", repr(LR)))


def _batch(cfg, rng):
    """One seeded batch of 8 rows for ``cfg``'s family (32 tokens; vlm:
    its patches, N(0, 1), then 32 - P text tokens; encdec: 16 frames,
    N(0, 1), and 16 decoder tokens)."""
    tok = lambda n: rng.integers(0, cfg.vocab_size, (8, n)).astype(np.int32)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(8, 16, cfg.d_model)).astype(
            np.float32), "dec_tokens": tok(16), "labels": tok(16)}
    if cfg.family == "vlm":
        from repro_torch.models.vlm import D_VISION
        P = cfg.num_patches
        return {"tokens": tok(32 - P), "patch_embeds": rng.normal(
            size=(8, P, D_VISION)).astype(np.float32), "labels": tok(32 - P)}
    return {"tokens": tok(32), "labels": tok(32)}


def _inputs(path, cases=None):
    """Seeded numpy params (N(0, 0.05), norms zero) and batches, keyed
    ``<arch>|<keystr path>`` and ``batch|<arch>|<step>|<field>``: each
    arch's reduced config with the first of ``cases``' overrides for it
    (its cases' shapes must agree)."""
    import dataclasses

    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_items
    cases = CASES if cases is None else cases
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in sorted({c[0] for c in cases.values()}):
        kw = next(c[4] for c in cases.values() if c[0] == arch)
        cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
        for key, leaf in tree_items(M.param_shapes(cfg)):
            norm = re.search(r"(ln\d?|norm)'\]$", key) is not None
            arrays[f"{arch}|{key}"] = (
                np.zeros(leaf.shape, np.float32) if norm else
                (rng.normal(size=tuple(leaf.shape)) * 0.05).astype(
                    np.float32))
        for i in range(STEPS):
            for k, a in _batch(cfg, rng).items():
                arrays[f"batch|{arch}|{i}|{k}"] = a
    np.savez(path, **arrays)


def spawn(out, env, cases=None, kept=None, split=False):
    """The four ranks running ``cases`` and the reference subprocess
    running them (``split``: one a case, each writing
    ``reference<case>.pkl``), started on the inputs in ``out``."""
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _script(_RANK, cases, kept), str(out), str(r),
         str(WORLD), str(out / "store")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    cases = CASES if cases is None else cases
    runs = ([({k: v}, k) for k, v in cases.items()] if split
            else [(cases, "")])
    refs = [subprocess.Popen(
        [sys.executable, "-c", _script(_REFERENCE, c, kept), str(out), tag],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c, tag in runs]
    return ranks + refs


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launcher(ckpt, env):
    """The training launcher on four CPU ranks under torchrun's
    environment (a free port on the loopback address)."""
    port = str(_free_port())
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device",
            "cpu", "--steps", "4", "--batch", "8", "--seq", "16",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                 LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]


def _finish(procs, deadline):
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            logs.append((p.returncode, so, se[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, so, se in logs:
        assert rc == 0, f"a process exited {rc}:\n{so[-2000:]}\n{se}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, the reference and the launcher once; return
    ``load(who)`` over their result files and the launcher's runs."""
    out = tmp_path_factory.mktemp("sharded_train")
    _inputs(out / "inputs.npz")
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    deadline = t0 + SPAWN_TIMEOUT
    procs = spawn(out, env)
    dry = subprocess.Popen(
        [sys.executable, "-c", _script(_DRYRUN), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the launcher: uninterrupted to step 4 (checkpoints at 2 and 4), then
    # again from its step-2 checkpoint alone
    whole, resumed = out / "launch_whole", out / "launch_resumed"
    first = _finish(_launcher(whole, env), deadline)
    shutil.copytree(whole / "step_000000002", resumed / "step_000000002")
    second = _finish(_launcher(resumed, env), deadline)
    _finish(procs + [dry], deadline)

    def load(who):
        with open(out / f"{who}.pkl", "rb") as f:
            return pickle.load(f)
    load.launcher = {"whole": (whole, first[0][1]),
                     "resumed": (resumed, second[0][1])}
    load.seconds = time.monotonic() - t0
    load.inputs = dict(np.load(out / "inputs.npz"))
    return load


def _tol(port, ref_sharded, ref_one, floor):
    """4 x the reference's own sharded-vs-one-device distance, at least
    ``floor``."""
    return max(4 * abs(ref_sharded - ref_one), floor), abs(port - ref_sharded)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference(runs, case):
    got = runs("rank0")[case]
    assert "error" not in got, got.get("error")
    ref = runs("reference")[case]
    for (l, g), (rl, rg), (ol, og) in zip(got["bf16"]["metrics"],
                                         ref["sharded"]["metrics"],
                                         ref["one"]["metrics"]):
        # floors: 2e-5 of the loss (its fp32 sums over 256 tokens of
        # bf16 logits), 1e-3 of the norm (bf16 gradients: 2^-8 a sum)
        tol, err = _tol(l, rl, ol, 2e-5 * abs(rl))
        assert err <= tol, (case, "loss", l, rl, ol)
        tol, err = _tol(g, rg, og, 1e-3 * abs(rg))
        assert err <= tol, (case, "grad_norm", g, rg, og)
    arch = CASES[case][0]
    for key, want in ref["sharded"]["params"].items():
        have = got["bf16"]["params"][key].astype(np.float32)
        own = np.abs(want - ref["one"]["params"][key])
        ulp = 2.0 ** -8 * float(np.abs(want).max())     # one bf16 ulp
        # on the mean: 4 x the reference's own mean distance (an entry a
        # 2^-10 of the leaf's mean size at least)
        assert float(np.abs(have - want).mean()) <= max(
            4 * float(own.mean()), 2.0 ** -10 * float(np.abs(want).mean()),
            1e-12), key
        # entry by entry: twice the largest change the two steps made to
        # the leaf, and an ulp: both optimizers' first updates are
        # normalized, so an entry whose gradient is near 0 may step either
        # way in two bf16 evaluations of one function
        moved = float(np.abs(want - runs.inputs[f"{arch}|{key}"]).max())
        assert float(np.abs(have - want).max()) <= 2 * moved + ulp, key


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_one_rank_in_float64(runs, case):
    got = runs("rank0")[case]
    one = got["one_rank"]
    for (l, _), ol in zip(got["f64"]["metrics"], one["losses"]):
        assert abs(l - ol) <= 1e-10 * abs(ol), (case, l, ol)
    for key, want in one["grads0"].items():
        err = np.linalg.norm(got["grads0"][key] - want)
        assert err <= 1e-10 * np.linalg.norm(want), (case, key, err)
    for key, want in one["params"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got["f64"]["params"][key], want, rtol=0,
                                   atol=8 * 2.0 ** -24 * scale,
                                   err_msg=key)


@pytest.mark.parametrize("fault", ["fault_copy", "fault_data"])
def test_planted_faults_read_above_1e_3(runs, fault):
    got = runs("rank0")["granite_adamw_2x2"]
    want = got["one_rank"]["grads0"]
    worst = max(np.linalg.norm(got[fault][k] - w) / np.linalg.norm(w)
                for k, w in want.items() if np.linalg.norm(w) > 0)
    assert worst > 1e-3, (fault, worst)


@pytest.mark.parametrize("fault", ["fault_row", "fault_tp_copy"])
def test_tensor_parallel_faults_read_above_1e_3(runs, fault):
    """internlm2 on (2, 2), float64: the MLP's row product without its
    ``ReduceFromGroup``, and ``CopyToGroup``'s backward without its
    all-reduce (the MLPs' and the vocab's inputs), part the step-0
    gradient from the one-rank step's by more than 1e-3."""
    got = runs("rank0")["internlm2_adamw_2x2"]
    want = got["one_rank"]["grads0"]
    worst = max(np.linalg.norm(got[fault][k] - w) / np.linalg.norm(w)
                for k, w in want.items() if np.linalg.norm(w) > 0)
    assert worst > 1e-3, (fault, worst)


_TP_NAMES = {False: ("w_gate", "w_up", "w_down", "embed", "head"),
             True: ("w_gate", "w_up", "w_down", "embed", "head", "wq", "wk",
                    "wv", "wo")}


@pytest.mark.parametrize("case", KEPT)
def test_kept_leaves_leave_the_all_gather(runs, case):
    """A rank's all-gather bytes of a step fall, from every leaf gathered
    to the tensor-parallel leaves kept split, by exactly those leaves'
    whole bytes (their ``model`` half and their ``data`` gather of it);
    the kept step's bytes are the ones the dry run reckons
    (``test_dry_run_reckons_the_ranks_bytes``)."""
    import dataclasses

    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_items
    arch, kw = CASES[case][0], CASES[case][4]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    names = _TP_NAMES[cfg.attn_shard in ("heads", "head_dim")]
    kept = sum(leaf.numel() * leaf.element_size()
               for path, leaf in tree_items(M.param_shapes(cfg))
               if re.search(r"\['(\w+)'\]$", path).group(1) in names)
    for rank in range(WORLD):
        got = runs(f"rank{rank}")[case]["gather_bytes"]
        assert got["gathered"] - got["kept"] == kept, (rank, got, kept)


@pytest.mark.parametrize("rank", range(WORLD))
def test_local_shapes_are_the_specs_shards(runs, rank):
    rec = runs(f"rank{rank}")
    for case in CASES:
        assert rec[case]["bad_local_shapes"] == [], case
        assert rec[case]["n_leaves"] > 0
        assert rec[case]["init_state_equal"], case


def test_tuple_entry_splits_as_the_reference(runs):
    """A dim split over ``("pod", "data")`` gives each mesh position the
    rows JAX gives it (major to minor)."""
    want = runs("reference")["tuple_order"]
    for rank in range(WORLD):
        got = runs(f"rank{rank}")["tuple_order"]
        assert got["rows"] == want[got["coord"]], (rank, got)


def test_sharded_checkpoint_restores_on_fewer_ranks(runs):
    ck0 = runs("rank0")["granite_adamw_2x2"]["ckpt"]
    ck1 = runs("rank1")["granite_adamw_2x2"]["ckpt"]
    assert ck0["two"] and ck1["two"] and ck0["one"]
    assert ck0["two_sharded"] > 0
    assert runs("rank2")["granite_adamw_2x2"]["ckpt"] == {}


def test_launcher_resumes_on_four_ranks(runs):
    (whole, out_w), (resumed, out_r) = (runs.launcher["whole"],
                                        runs.launcher["resumed"])
    head = out_w.splitlines()[0]
    assert "ranks=4 backend=gloo mesh=(4, 1)" in head, head
    assert out_w.splitlines()[-1] == out_r.splitlines()[-1]
    assert out_w.splitlines()[-1].startswith("done: 4 steps, loss ")
    a = np.load(whole / "step_000000004" / "arrays.npz")
    b = np.load(resumed / "step_000000004" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 30
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reference_explicit_axes_fault(runs):
    """Under ``jax.make_mesh``'s default axis types (Explicit in jax 0.9)
    the reference's sharded granite-moe step raises a
    ``ShardingTypeError`` (here at the embedding's gather of the
    vocab-sharded table); the cases above build an Auto-axes mesh."""
    got = runs("reference")["explicit"]
    assert got["raised"] == "ShardingTypeError", got


def test_accumulated_moe_step_drops(runs):
    """The accumulation case's MoE layers drop assignments in every call
    of step 0 on every rank (both dtypes), so the case holds the
    micro-batches' capacity: two micro-batches a step, one dispatch a
    layer each."""
    layers = 2
    for rank in range(WORLD):
        rec = runs(f"rank{rank}")["granite_adamw_2x2_accum2"]
        for dt in ("bf16", "f64"):
            drops = rec[f"{dt}_drops"]
            print(f"rank {rank} {dt}: dropped assignments a dispatch {drops}")
            assert len(drops) == 2 * layers, (rank, dt, drops)
            assert min(drops) > 0, (rank, dt, drops)


def test_dry_run_reckons_the_ranks_bytes(runs):
    """The dry run of the granite AdamW case (``launch.dryrun`` on ``meta``
    tensors over a fake group of four) reckons, to the byte, the
    collective bytes each gloo rank's ``sharded.BYTES`` counted in step 0
    and each rank's shard bytes of the params and the optimizer state."""
    dry = runs("dryrun")
    names = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter",
             "collective_permute": "collective-permute"}
    want = {k: v for k, v in dry["collective_bytes_per_device"].items() if v}
    assert set(want) == set(names.values()), want
    for rank in range(WORLD):
        rec = runs(f"rank{rank}")["granite_adamw_2x2"]
        got = {names[k]: v for k, v in rec["bf16_bytes"].items()}
        assert got == want, (rank, got, want)
        assert rec["local_bytes"] == {
            k: dry["argument_bytes_by_tree"][k]
            for k in ("params", "opt_state")}, rank
