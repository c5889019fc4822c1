"""The sharded serve steps (``train.step.make_prefill_step`` and
``make_decode_step`` on DTensor params and caches, ``attention``'s
split-slot and split-head caches, ``distributed.sharded.softmax_combine``,
``launch.sharding.move``) on four gloo CPU ranks, against the reference's
sharded steps on a 4-device CPU mesh and against the port's own one-rank
steps; the dry run of three of its cells.

One module fixture starts, together: four gloo ranks (a ``file://``
store, no TCP port) that run every case; one reference subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, a (2, 2) mesh of
``AxisType.Auto`` axes, each step jitted once with ``in_shardings`` from
``named(mesh, specs)`` as ``src/repro/launch/dryrun.py`` builds them, the
prefill under the prefill cell's rules, the cache and params
``device_put`` to the decode cell's, then the decode steps); and one dry
run of three reduced cells on ``meta`` tensors over a fake group of four.
All read the same seeded numpy params (N(0, 0.05), norms zero), prompts,
patch embeddings, frames and decode tokens.

Cases, reduced configs on a (2, 2) ``("data", "model")`` mesh, each a
prefill, the cache moved to the decode rules, then decode steps fed
seeded tokens (``CASES``): internlm2 batch-split (batch 8, ``fsdp=None``),
split-KV (``attn_shard="pad_heads"``, ``kv_seq="model"``) and
context-parallel (batch 2 < 2 x 2, ``kv_seq="data"``, ``batch=()``);
granite-moe split-KV and context-parallel (its MoE runs on every data
rank's same tokens); gemma2-27b context-parallel on the
``split_local_global`` dict cache (a 16-slot local ring over the data
ranks, decode past position 16 wrapping it); recurrentgemma at 4 layers,
context-parallel (its ring over ``data``, the RG-LRU state and conv rows
over ``model``, gathered for the step); mamba2 (the state over ``model``);
seamless with frames (cross K/V over ``kv_seq`` and both caches' KV heads
over ``model``); phi-3-vision, one prefill with patches (KV heads over
``model``); internlm2 context-parallel at 64 slots with a 12-token
prompt, where the second data rank holds no live slot; and granite-moe
with the experts gathered on every rank (no current mesh, the
reference's ``--no-shard-map-moe``): one train step and one batch-split
decode step; internlm2 under ``attn_shard="heads"``, batch-split (the
attention head-parallel over a cache whose KV heads are split); and an
internlm2 prefill under ``attn_pad_to = 8`` (rank 1 of each ``model``
pair attends padded heads alone).  The port's steps compute
tensor-parallel over ``model`` (the MLPs, the vocab, the heads under
``"heads"``, the head dim under ``"head_dim"`` with the cache whole in
it, the padded heads of a prefill under ``"pad_heads"``): a rank's
logits are its rows and its vocab columns, gathered over both axes
before they are compared.  ``pad_heads`` with ``attn_pad_to = 4``: the
published internlm2 and granite-moe pad 16 query heads to 16 on a
16-wide model axis (no padding, the K/V repeated a head); the reduced 4
heads on the 2-wide axis keep that (4 heads, no padding; the prefill
attends 2 a rank).  Slots are few enough that both halves of a split
sequence hold live slots (but in the empty-rank case).

Held:

* against the reference's sharded steps, in bf16: the last position's
  logits within rtol = atol = 2e-2 and the tokens equal, except at a
  proven near-tie (the reference's top-2 gap within twice the measured
  distance of the two logits); each cache leaf within the module bound
  rtol = atol = 2e-2 (integer leaves equal); the gathered-experts train
  step's loss, grad norm and params as ``tests/test_torch_sharded_train``
  holds the sharded step;
* against the port's one-rank steps, in float64, each decode step fed
  the step's own tokens (the DTensor it returns, ``[:, None]``): tokens
  equal, logits and every cache leaf within 1e-10 (relative to the
  leaf's largest entry);
* planted faults read above 1e-3 (context-parallel internlm2, float64):
  the combine without its all-reduces (each rank's own softmax), the
  decode write made at every rank's local slot, and the MLP's row
  product without its all-reduce over ``model``;
* every rank's local cache shapes are its specs' shards, under the
  prefill and under the decode rules;
* the dry run's collective bytes of a step and cache shard bytes equal
  each rank's, to the byte, for the batch-split prefill, the split-KV
  decode and the context-parallel decode (a prefill's collectives carry
  its prompt's activations, so its bytes are the cell of the prompt's
  length).
"""
import os
import pickle
import re
import subprocess
import sys
import textwrap
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest

WORLD = 4
SPAWN_TIMEOUT = 600
LR = 1e-3
PAD = {"attn_shard": "pad_heads", "attn_pad_to": 4}
# name: (arch, config overrides, batch, slots, prompt tokens, decode steps)
CASES = {
    "internlm2_batch": ("internlm2-1.8b", {}, 8, 32, 12, 3),
    "internlm2_splitkv": ("internlm2-1.8b", PAD, 8, 32, 20, 3),
    "internlm2_cp": ("internlm2-1.8b", {}, 2, 32, 20, 3),
    "granite_splitkv": ("granite-moe-1b-a400m", PAD, 8, 32, 20, 3),
    "granite_cp": ("granite-moe-1b-a400m", {}, 2, 32, 20, 3),
    "gemma2_cp": ("gemma2-27b", {}, 2, 32, 20, 4),
    "recurrentgemma_cp": ("recurrentgemma-9b", {"num_layers": 4}, 2, 32, 20,
                          3),
    "mamba2": ("mamba2-130m", {}, 8, 32, 12, 3),
    "seamless_cp": ("seamless-m4t-large-v2", {}, 2, 32, 20, 3),
    "phi3_prefill": ("phi-3-vision-4.2b", {}, 8, 32, 12, 0),
    "empty_rank": ("internlm2-1.8b", {}, 2, 64, 12, 3),
    # H = 4 and KV = 2 divide the 2 model ranks: head-parallel attention
    # over a cache whose KV heads are split, batch-split decode
    "internlm2_heads": ("internlm2-1.8b", {"attn_shard": "heads"}, 8, 32, 12,
                        3),
    "granite_gathered": ("granite-moe-1b-a400m", {}, 8, 32, 12, 1),
    # 8 padded heads, 4 a model rank: rank 1 of each pair holds padding
    # alone in the prefill
    "internlm2_pad8_prefill": ("internlm2-1.8b", {"attn_shard": "pad_heads",
                                                  "attn_pad_to": 8},
                               8, 32, 12, 0),
}
ARCHS = sorted({c[0] for c in CASES.values()})
# the cells the dry run traces, held to the ranks' bytes
DRY = {"internlm2_batch": "prefill", "internlm2_splitkv": "decode",
       "internlm2_cp": "decode"}

_COMMON = textwrap.dedent("""
    import os, pickle, re, sys
    import numpy as np
    OUT = sys.argv[1]
    CASES = @CASES@
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

    def prompt(name):
        return {k.split("|")[2]: a for k, a in INPUTS.items()
                if k.startswith(f"prompt|{name}|")}

    def start(name):
        # the first decode position: after the patches and the prompt
        arch, kw, B, C, S, steps = CASES[name]
        return S + (8 if arch.startswith("phi") else 0)

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
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import interop, models as M
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import sharded
    from repro_torch.launch import RULES
    from repro_torch.launch.sharding import (cache_struct, distribute,
                                             init_state, move, rules_for)
    from repro_torch.models import attention, common
    from repro_torch.models.common import P, set_current_mesh
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.step import make_decode_step, make_prefill_step
    from repro_torch.tree import cache_items, tree_items, tree_map

    F64 = torch.float64
    MESH = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    LOGITS = []

    def recording(fn):
        # the serve functions, recording this rank's last-position logits
        def run(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            LOGITS.append(logits[:, -1])
            return logits, cache
        return run

    M.prefill_fn = recording(M.prefill_fn)
    M.decode_fn = recording(M.decode_fn)

    def config(name, f64=False):
        arch, kw, B, C, S, steps = CASES[name]
        cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
        return dataclasses.replace(cfg, dtype=F64, param_dtype=F64) \\
            if f64 else cfg

    def params(name, cfg):
        p = interop.params_from_reference(nested(CASES[name][0]), cfg,
                                          device="cpu")
        return p if cfg.dtype != F64 else tree_map(lambda t: t.to(F64), p)

    def batch(name, cfg):
        b = {k: torch.as_tensor(v) for k, v in prompt(name).items()}
        return {k: v.to(F64) if v.is_floating_point() and
                cfg.dtype == F64 else v for k, v in b.items()}

    def cells(name):
        arch, kw, B, C, S, steps = CASES[name]
        return (ShapeCell("prefill", "prefill", C, B),
                ShapeCell("decode", "decode", C, B))

    def whole(t):
        return sharded.gather(t).double().numpy()

    def local_shapes_ok(cache, specs):
        sizes = dict(zip(MESH.mesh_dim_names, MESH.shape))
        bad = []
        for (path, leaf), (_, spec) in zip(cache_items(cache),
                                           cache_items(specs)):
            want = list(leaf.shape)
            for d, e in enumerate(spec):
                for a in (() if e is None else e if isinstance(e, tuple)
                          else (e,)):
                    want[d] //= sizes[a]
            if list(leaf.to_local().shape) != want:
                bad.append((path, list(leaf.to_local().shape), want))
        return bad

    def local_bytes(cache):
        return sum(l.to_local().numel() * l.element_size()
                   for _, l in cache_items(cache))

    def serve(name, f64=False, feed_back=False):
        # prefill, the cache and params moved to the decode rules, decode
        arch, kw, B, C, S, steps = CASES[name]
        cfg = config(name, f64)
        cp, cd = cells(name)
        rp, rd = rules_for(cfg, cp, MESH), rules_for(cfg, cd, MESH)
        full = params(name, cfg)
        _, specs_p = cache_struct(cfg, cp, rp)
        _, specs_d = cache_struct(cfg, cd, rd)
        cache = distribute(M.make_cache(cfg, B, C, device="cpu",
                                        t_enc=C // 2,
                                        split_local_global=True),
                           MESH, specs_p)
        sp = distribute(full, MESH, M.param_specs(cfg, rp))
        rec = {"rules": (rp.batch, rp.kv_seq, rd.batch, rd.kv_seq, rd.fsdp),
               "bad_shapes": local_shapes_ok(cache, specs_p)}
        del LOGITS[:]
        sharded.reset()
        tok, cache = make_prefill_step(cfg, rp)(sp, batch(name, cfg), cache)
        rec["prefill_bytes"] = dict(sharded.BYTES)
        rec["cache_bytes_prefill"] = local_bytes(cache)
        rec["tokens"] = [sharded.gather(tok).numpy()]
        rec["tok_placement"] = [str(p) for p in tok.placements]
        if steps:
            sharded.reset()
            cache = move(cache, MESH, specs_d)
            sp = move(sp, MESH, M.param_specs(cfg, rd))
            rec["move_bytes"] = dict(sharded.BYTES)
            rec["bad_shapes"] += local_shapes_ok(cache, specs_d)
            rec["cache_bytes_decode"] = local_bytes(cache)
        step = make_decode_step(cfg, rd)
        bt = rd.resolve("batch")
        rec["decode_bytes"] = []
        for i in range(steps):
            if feed_back:
                fed = move({"t": tok}, MESH, {"t": P(bt)})["t"][:, None]
            else:
                fed = distribute({"t": torch.as_tensor(
                    INPUTS[f"decode|{name}|{i}"])}, MESH,
                    {"t": P(bt, None)})["t"]
            sharded.reset()
            tok, cache = step(sp, fed, start(name) + i, cache)
            rec["decode_bytes"].append(dict(sharded.BYTES))
            rec["tokens"].append(sharded.gather(tok).numpy())
        rec["logits"] = [gather_rows(l, rp if j == 0 else rd, cfg)
                         for j, l in enumerate(LOGITS)]
        rec["cache"] = {path: whole(l) for path, l in cache_items(cache)}
        return rec

    def gather_rows(logits, rules, cfg):
        # the data ranks' rows of the logits, in order, and the model
        # ranks' columns of a tensor-parallel vocab
        if logits.shape[-1] < cfg.vocab_size:
            logits = sharded.AxisComm(MESH, ("model",)).gather(
                logits.movedim(-1, 0)).movedim(0, -1)
        bt = rules.resolve("batch")
        if not bt:
            return logits.double().numpy()
        return sharded.AxisComm(MESH, (bt,) if isinstance(bt, str)
                                else bt).gather(logits).double().numpy()

    def one_rank(name):
        # the port's one-device steps in float64, fed their own tokens
        arch, kw, B, C, S, steps = CASES[name]
        cfg = config(name, True)
        p = params(name, cfg)
        set_current_mesh(None)
        cache = M.make_cache(cfg, B, C, device="cpu", t_enc=C // 2,
                             split_local_global=True)
        del LOGITS[:]
        tok, cache = make_prefill_step(cfg, RULES)(p, batch(name, cfg), cache)
        toks = [tok.numpy()]
        step = make_decode_step(cfg, RULES)
        for i in range(steps):
            tok, cache = step(p, tok[:, None], start(name) + i, cache)
            toks.append(tok.numpy())
        set_current_mesh(MESH)
        return {"tokens": toks,
                "logits": [l.double().numpy() for l in LOGITS],
                "cache": {path: l.double().numpy()
                          for path, l in cache_items(cache)}}

    def faults(name):
        out = {}
        combine = sharded.softmax_combine
        sharded.softmax_combine = lambda m, l, o, comm: o / l[..., None]
        try:
            out["combine_without_all_reduce"] = serve(name, True, True)
        finally:
            sharded.softmax_combine = combine
        write = attention.cache_write

        def everywhere(lk, lv, lp, k, v, pos, window, shard=None):
            if shard is None or shard.seq is None or pos.shape[0] != 1:
                return write(lk, lv, lp, k, v, pos, window, shard)
            return write(lk, lv, lp, k, v, pos, lk.shape[1],
                         shard._replace(seq=None))
        attention.cache_write = everywhere
        try:
            out["write_on_every_rank"] = serve(name, True, True)
        finally:
            attention.cache_write = write
        tp_sum = common.tp_sum
        common.tp_sum = lambda y, part: (y if part == "mlp"
                                         else tp_sum(y, part))
        try:
            out["row_without_all_reduce"] = serve(name, True, True)
        finally:
            common.tp_sum = tp_sum
        return out

    def gathered_experts(name):
        # no current mesh: the experts gathered on every rank
        arch, kw, B, C, S, steps = CASES[name]
        cfg = config(name)
        set_current_mesh(None)
        rules = rules_for(cfg, ShapeCell("train", "train", 32, 8), MESH)
        specs = M.param_specs(cfg, rules)
        sp = distribute(params(name, cfg), MESH, specs)
        opt = AdamW()
        st = init_state(opt, sp, specs)
        b = {k: torch.as_tensor(INPUTS[f"train|{name}|{k}"])
             for k in ("tokens", "labels")}
        sp, st, m = make_train_step(cfg, rules, opt, lambda s: @LR@)(
            sp, st, b, 0)
        rec = {"metrics": (float(m["loss"]), float(m["grad_norm"])),
               "params": {k: whole(v) for k, v in tree_items(sp)}}
        rec["serve"] = serve(name)
        set_current_mesh(MESH)
        return rec

    def refusals():
        # a cache dim that does not split evenly, and a cache placed by
        # the prefill rules given to the decode step
        cfg = config("internlm2_cp")
        cp, cd = cells("internlm2_cp")
        rp, rd = rules_for(cfg, cp, MESH), rules_for(cfg, cd, MESH)
        specs_p = cache_struct(cfg, cp, rp)[1]
        out = {}
        try:
            distribute(M.make_cache(cfg, 3, 32, device="cpu"), MESH, specs_p)
        except ValueError as e:
            out["uneven"] = str(e)
        cache = distribute(M.make_cache(cfg, 2, 32, device="cpu"), MESH,
                           specs_p)
        sp = distribute(params("internlm2_cp", cfg), MESH,
                        M.param_specs(cfg, rd))
        try:
            make_decode_step(cfg, rd)(sp, torch.zeros((2, 1),
                                                      dtype=torch.int32),
                                      0, cache)
        except ValueError as e:
            out["misplaced"] = str(e)
        return out

    import time
    T0 = time.perf_counter()
    record = {"refusals": refusals()}
    for name in CASES:
        try:
            record.setdefault("seconds", {})[name] = time.perf_counter() - T0
            if name == "granite_gathered":
                record[name] = gathered_experts(name)
                continue
            set_current_mesh(MESH)
            record[name] = {"bf16": serve(name),
                            "f64": serve(name, True, True)}
            if RANK == 0:
                record[name]["one_rank"] = one_rank(name)
            if name == "internlm2_cp":
                record[name]["faults"] = faults(name)
        except Exception:
            record[name] = {"error": traceback.format_exc()}
            raise
        finally:
            dump(f"rank{RANK}", record)
    set_current_mesh(None)
    dist.destroy_process_group()
""")

_REFERENCE = _COMMON + textwrap.dedent("""
    import dataclasses, traceback
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    import repro.models as M
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCell
    from repro.launch.sharding import (batch_struct, cache_struct, named,
                                       rules_for)
    from repro.launch.train import ShardingRules
    from repro.models.common import set_current_mesh
    from repro.train import AdamW, make_train_step

    MESH = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ONE = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                        vocab=None, experts=None, fsdp=None, head_dim=None,
                        state=None, act_heads=None)

    def config(name):
        arch, kw, B, C, S, steps = CASES[name]
        return dataclasses.replace(get_config(arch, reduced=True), **kw)

    def params(name, cfg):
        return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                            nested(CASES[name][0]), M.param_shapes(cfg))

    def f32(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32)
                                                    if v.dtype == jnp.bfloat16
                                                    else v)
                for k, v in flat}

    def last(logits):
        out = logits[:, -1, :]
        return out, jnp.argmax(out, axis=-1).astype(jnp.int32)

    def serve(name, one=False):
        # the sharded steps, or (one) the one-device steps
        arch, kw, B, C, S, steps = CASES[name]
        cfg = config(name)
        cp = ShapeCell("prefill", "prefill", C, B)
        cd = ShapeCell("decode", "decode", C, B)
        rp, rd = rules_for(cfg, cp, MESH), rules_for(cfg, cd, MESH)
        if one:
            rp = rd = ONE
        ps_p = named(MESH, M.param_specs(cfg, rp))
        ps_d = named(MESH, M.param_specs(cfg, rd))
        cs_p = named(MESH, cache_struct(cfg, cp, rp)[1])
        cs_d = named(MESH, cache_struct(cfg, cd, rd)[1])
        bspecs = batch_struct(cfg, cp, rp)[1]
        inputs = prompt(name)
        bs = named(MESH, {k: bspecs[k] for k in inputs})

        def prefill(p, b, c):
            logits, c = M.prefill_fn(p, cfg, rp, b, c)
            return (*last(logits), c)

        def decode(p, t, pos, c):
            logits, c = M.decode_fn(p, cfg, rd, t, pos, c)
            return (*last(logits), c)
        fp = jax.jit(prefill, in_shardings=(ps_p, bs, cs_p),
                     out_shardings=(None, None, cs_p))
        fd = jax.jit(decode, in_shardings=(
            ps_d, NamedSharding(MESH, P(rd.resolve("batch"), None)),
            NamedSharding(MESH, P()), cs_d), out_shardings=(None, None, cs_d))
        if one:
            fp, fd = jax.jit(prefill), jax.jit(decode)
            ps_p = ps_d = cs_p = cs_d = bs = jax.devices()[0]
        p = jax.device_put(params(name, cfg), ps_p)
        cache = jax.device_put(M.make_cache(cfg, B, C, t_enc=C // 2,
                                            split_local_global=True), cs_p)
        b = jax.device_put({k: jnp.asarray(v) for k, v in inputs.items()},
                           bs)
        logits, tok, cache = fp(p, b, cache)
        rec = {"logits": [np.asarray(logits)], "tokens": [np.asarray(tok)]}
        if steps:
            p = jax.device_put(p, ps_d)
            cache = jax.device_put(cache, cs_d)
        for i in range(steps):
            logits, tok, cache = fd(p, jnp.asarray(
                INPUTS[f"decode|{name}|{i}"]), jnp.int32(start(name) + i),
                cache)
            rec["logits"].append(np.asarray(logits))
            rec["tokens"].append(np.asarray(tok))
        rec["cache"] = f32(cache)
        return rec

    def train(name, mesh):
        # one AdamW step, sharded (Auto axes) or on one device
        cfg = config(name)
        opt = AdamW()
        if mesh is None:
            fn, put = jax.jit(make_train_step(cfg, ONE, opt, lambda s: @LR@)), \\
                (lambda t, s: t)
            ps = ss = bs = None
        else:
            rules = rules_for(cfg, ShapeCell("train", "train", 32, 8), mesh)
            ps = named(mesh, M.param_specs(cfg, rules))
            ss = named(mesh, opt.state_specs(M.param_specs(cfg, rules)))
            bs = named(mesh, batch_struct(cfg, ShapeCell(
                "train", "train", 32, 8), rules)[1])
            fn = jax.jit(make_train_step(cfg, rules, opt, lambda s: @LR@),
                         in_shardings=(ps, ss, bs, NamedSharding(mesh, P())),
                         out_shardings=(ps, ss, None))
            put = jax.device_put
        p = put(params(name, cfg), ps)
        st = put(opt.init(p), ss)
        b = put({k: jnp.asarray(INPUTS[f"train|{name}|{k}"])
                 for k in ("tokens", "labels")}, bs)
        p, st, m = fn(p, st, b, jnp.int32(0))
        return {"metrics": (float(m["loss"]), float(m["grad_norm"])),
                "params": f32(p)}

    import time
    T0 = time.perf_counter()
    record = {}
    for name in CASES:
        try:
            record.setdefault("seconds", {})[name] = time.perf_counter() - T0
            if name == "granite_gathered":
                set_current_mesh(None)
                record[name] = {"sharded": train(name, MESH),
                                "one": train(name, None),
                                "serve": serve(name),
                                "serve_one": serve(name, one=True)}
                continue
            set_current_mesh(MESH)
            record[name] = serve(name)
        except Exception:
            record[name] = {"error": traceback.format_exc()}
        finally:
            dump("reference", record)
""")

_DRYRUN = _COMMON + textwrap.dedent("""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    DRY = @DRY@

    def trace(cfg, kind, C, B):
        with dryrun.fake_group(4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                                  "model"))
            return dryrun.analyze(dryrun.lower_config(
                cfg, ShapeCell(kind, kind, C, B), mesh)[0])

    out = {}
    for name, kind in DRY.items():
        arch, kw, B, C, S, steps = CASES[name]
        cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
        info = trace(cfg, kind, C, B)
        out[name] = {k: info[k] for k in (
            "collective_bytes_per_device", "argument_bytes_by_tree",
            "null_reason", "flops_per_device")}
        if kind == "prefill" and S != C:
            # a prefill's collectives carry its S prompt tokens' activations
            # (the tensor-parallel sums), whatever the cache's C slots: the
            # bytes of the cell of S slots
            out[name]["collective_bytes_per_device"] = trace(
                cfg, kind, S, B)["collective_bytes_per_device"]
    dump("dryrun", out)
""")


def _script(text):
    return (text.replace("@CASES@", repr(CASES)).replace("@LR@", repr(LR))
            .replace("@DRY@", repr(DRY)))


def _inputs(path):
    """Seeded numpy params (N(0, 0.05), norms zero), keyed ``<arch>|<keystr
    path>``; each case's prompt (``prompt|<case>|<field>``: tokens,
    patches, frames) and decode tokens (``decode|<case>|<step>``); the
    gathered-experts case's train batch (``train|<case>|<field>``)."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.models.vlm import D_VISION
    from repro_torch.tree import tree_items
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        for key, leaf in tree_items(M.param_shapes(cfg)):
            norm = re.search(r"(ln\d?|lnx|norm|gate_ln)'\]$", key) is not None
            arrays[f"{arch}|{key}"] = (
                np.zeros(leaf.shape, np.float32) if norm else
                (rng.normal(size=tuple(leaf.shape)) * 0.05).astype(
                    np.float32))
    for name, (arch, kw, B, C, S, steps) in CASES.items():
        V = get_config(arch, reduced=True).vocab_size
        D = get_config(arch, reduced=True).d_model
        toks = rng.integers(0, V, (B, S)).astype(np.int32)
        if arch.startswith("seamless"):
            arrays[f"prompt|{name}|dec_tokens"] = toks
            arrays[f"prompt|{name}|frames"] = rng.normal(
                size=(B, C // 2, D)).astype(np.float32)
        else:
            arrays[f"prompt|{name}|tokens"] = toks
        if arch.startswith("phi"):
            arrays[f"prompt|{name}|patch_embeds"] = rng.normal(
                size=(B, 8, D_VISION)).astype(np.float32)
        for i in range(steps):
            arrays[f"decode|{name}|{i}"] = rng.integers(
                0, V, (B, 1)).astype(np.int32)
    for k in ("tokens", "labels"):
        arrays[f"train|granite_gathered|{k}"] = rng.integers(
            0, 512, (8, 32)).astype(np.int32)
    np.savez(path, **arrays)


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
    """Start the ranks, the reference and the dry run once; return
    ``load(who)`` over their result files."""
    out = tmp_path_factory.mktemp("sharded_serve")
    _inputs(out / "inputs.npz")
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _script(_RANK), str(out), str(r), str(WORLD),
         str(out / "store")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    ref = subprocess.Popen(
        [sys.executable, "-c", _script(_REFERENCE), str(out)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    dry = subprocess.Popen(
        [sys.executable, "-c", _script(_DRYRUN), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _finish(ranks + [ref, dry], time.monotonic() + SPAWN_TIMEOUT)

    def load(who):
        with open(out / f"{who}.pkl", "rb") as f:
            return pickle.load(f)
    load.seconds = time.monotonic() - t0
    load.inputs = dict(np.load(out / "inputs.npz"))
    return load


SERVE = [n for n in CASES if n != "granite_gathered"]


def _within(have, want, own, msg):
    """``have`` within rtol = atol = 2e-2 of ``want``, widened entry by
    entry by the reference's own distance ``|want - own|`` to its
    one-device result where ``own`` is given."""
    if own is None:
        np.testing.assert_allclose(have, want, rtol=2e-2, atol=2e-2,
                                   err_msg=msg)
        return
    excess = np.abs(have - want) - (2e-2 + 2e-2 * np.abs(want)
                                    + np.abs(want - own))
    assert float(excess.max()) <= 0, (msg, float(excess.max()))


def _serve_matches(got, ref, case, own=None):
    """Logits within 2e-2, tokens equal up to a proven near-tie, caches
    within 2e-2 (integer leaves equal); with ``own``, the reference's
    one-device run, each bound widened by the reference's own distance
    from it."""
    assert len(got["logits"]) == len(ref["logits"]) == len(got["tokens"])
    for i, (lg, lr, tg, tr) in enumerate(zip(got["logits"], ref["logits"],
                                             got["tokens"], ref["tokens"])):
        _within(lg, lr, None if own is None else own["logits"][i],
                f"{case} step {i}")
        dist = float(np.abs(lg - lr).max())
        top2 = np.sort(lr, axis=-1)[:, -2:]
        for row in np.flatnonzero(tg != tr):
            gap = float(top2[row, 1] - top2[row, 0])
            print(f"{case} step {i} row {row}: tokens {tg[row]} / {tr[row]}"
                  f", reference top-2 gap {gap:.3e}, distance {dist:.3e}")
            assert gap <= 2 * dist, (case, i, row, gap, dist)
    assert sorted(got["cache"]) == sorted(ref["cache"]), case
    for key, want in ref["cache"].items():
        have = got["cache"][key]
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(have, want, err_msg=key)
        else:
            _within(have, want, None if own is None else own["cache"][key],
                    f"{case} {key}")


@pytest.mark.parametrize("case", SERVE)
def test_sharded_serve_matches_the_reference(runs, case):
    got = runs("rank0")[case]
    assert "error" not in got, got.get("error")
    ref = runs("reference")[case]
    assert "error" not in ref, ref.get("error")
    _serve_matches(got["bf16"], ref, case)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


@pytest.mark.parametrize("case", SERVE)
def test_sharded_serve_matches_one_rank_in_float64(runs, case):
    got = runs("rank0")[case]
    assert "error" not in got, got.get("error")
    one, f64 = got["one_rank"], got["f64"]
    for i, (a, b) in enumerate(zip(f64["tokens"], one["tokens"])):
        np.testing.assert_array_equal(a, b, err_msg=f"{case} step {i}")
    assert len(f64["logits"]) == len(one["logits"]) == CASES[case][5] + 1
    for i, (a, b) in enumerate(zip(f64["logits"], one["logits"])):
        assert _rel(a, b) <= 1e-10, (case, i, _rel(a, b))
    for key, want in one["cache"].items():
        assert _rel(f64["cache"][key], want) <= 1e-10, (case, key)


@pytest.mark.parametrize("fault", ["combine_without_all_reduce",
                                   "write_on_every_rank",
                                   "row_without_all_reduce"])
def test_planted_faults_read_above_1e_3(runs, fault):
    got = runs("rank0")["internlm2_cp"]
    want = got["one_rank"]["logits"]
    worst = max(_rel(a, b) for a, b in zip(
        got["faults"][fault]["logits"], want))
    print(f"{fault}: {worst:.3e}")
    assert worst > 1e-3, (fault, worst)


@pytest.mark.parametrize("rank", range(WORLD))
def test_local_cache_shapes_are_the_specs_shards(runs, rank):
    rec = runs(f"rank{rank}")
    for case in SERVE:
        for dt in ("bf16", "f64"):
            assert rec[case][dt]["bad_shapes"] == [], (case, dt)
    assert rec["granite_gathered"]["serve"]["bad_shapes"] == []


def test_rules_of_the_cases(runs):
    """Each case runs the layout it is named for: (prefill batch, prefill
    kv_seq, decode batch, decode kv_seq, decode fsdp)."""
    want = {"internlm2_batch": (("data",), None, ("data",), None, None),
            "internlm2_splitkv": (("data",), None, ("data",), "model", None),
            "internlm2_cp": (("data",), None, (), "data", "data"),
            "granite_splitkv": (("data",), None, ("data",), "model", None),
            "granite_cp": (("data",), None, (), "data", "data"),
            "gemma2_cp": (("data",), None, (), "data", "data"),
            "recurrentgemma_cp": (("data",), None, (), "data", "data"),
            "mamba2": (("data",), None, ("data",), None, None),
            "seamless_cp": (("data",), None, (), "data", "data"),
            "empty_rank": (("data",), None, (), "data", "data"),
            "internlm2_heads": (("data",), None, ("data",), None, None)}
    rec = runs("rank0")
    for case, rules in want.items():
        assert rec[case]["bf16"]["rules"] == rules, case


def test_empty_rank_holds_no_live_slot(runs):
    """In the empty-rank case the second data rank's 32 slots stay empty
    through every step; the other cases' split halves both hold live
    slots by the last step."""
    inputs = runs("rank0")
    for case in SERVE:
        if CASES[case][5] == 0:
            continue
        for key, pos in inputs[case]["bf16"]["cache"].items():
            if not key.endswith("slot_pos"):
                continue
            halves = np.split(pos, 2, axis=-1)
            live = [bool((h >= 0).any()) for h in halves]
            if case == "empty_rank":
                assert live == [True, False], (case, key)
            elif inputs[case]["bf16"]["rules"][3] is not None:
                assert live == [True, True], (case, key)


def test_uneven_and_misplaced_caches_raise_naming_the_leaf(runs):
    for rank in range(WORLD):
        got = runs(f"rank{rank}")["refusals"]
        assert ".k: dim 1 of size 3 does not split over 2 ranks" in (
            got["uneven"]), got
        assert "cache leaf '.k'" in got["misplaced"], got
        assert "launch.sharding.move" in got["misplaced"], got


def test_decode_tokens_come_back_placed_by_the_batch(runs):
    rec = runs("rank0")
    assert rec["internlm2_batch"]["bf16"]["tok_placement"] == [
        "S(0)", "R"]
    assert rec["internlm2_cp"]["bf16"]["tok_placement"] == ["S(0)", "R"]


def test_gathered_experts_match_the_reference(runs):
    """No current mesh: the experts gathered on every rank, the reference's
    GSPMD dispatch (``set_current_mesh(None)``); one train step held as
    ``tests/test_torch_sharded_train.py`` holds the sharded step, one
    batch-split decode step as the cases above."""
    got = runs("rank0")["granite_gathered"]
    assert "error" not in got, got.get("error")
    ref = runs("reference")["granite_gathered"]
    assert "error" not in ref, ref.get("error")
    (l, g), (rl, rg), (ol, og) = (got["metrics"], ref["sharded"]["metrics"],
                                  ref["one"]["metrics"])
    assert abs(l - rl) <= max(4 * abs(rl - ol), 2e-5 * abs(rl)), (l, rl, ol)
    assert abs(g - rg) <= max(4 * abs(rg - og), 1e-3 * abs(rg)), (g, rg, og)
    arch = CASES["granite_gathered"][0]
    for key, want in ref["sharded"]["params"].items():
        have = got["params"][key].astype(np.float32)
        own = np.abs(want - ref["one"]["params"][key])
        ulp = 2.0 ** -8 * float(np.abs(want).max())
        assert float(np.abs(have - want).mean()) <= max(
            4 * float(own.mean()), 2.0 ** -10 * float(np.abs(want).mean()),
            1e-12), key
        moved = float(np.abs(want - runs.inputs[f"{arch}|{key}"]).max())
        assert float(np.abs(have - want).max()) <= 2 * moved + ulp, key
    # the reference's GSPMD-partitioned dispatch parts from its own
    # one-device run by 0.26 in row 1 of the prefill's logits (a routing
    # near-tie; its shard_map path and the port agree with the one-device
    # run there), so the bound takes the reference's own distance
    _serve_matches(got["serve"], ref["serve"], "granite_gathered",
                   own=ref["serve_one"])


@pytest.mark.parametrize("case", list(DRY))
def test_dry_run_reckons_the_ranks_bytes(runs, case):
    """The dry run of the cell (``launch.dryrun`` on ``meta`` tensors over
    a fake group of four) reckons, to the byte, the collective bytes each
    gloo rank's ``sharded.BYTES`` counted in each step of that kind and
    each rank's cache shard bytes."""
    dry = runs("dryrun")[case]
    assert dry["null_reason"] is None and dry["flops_per_device"] > 0
    names = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter",
             "collective_permute": "collective-permute"}
    want = {k: v for k, v in dry["collective_bytes_per_device"].items() if v}
    for rank in range(WORLD):
        rec = runs(f"rank{rank}")[case]["bf16"]
        if DRY[case] == "prefill":
            steps, cache = [rec["prefill_bytes"]], rec["cache_bytes_prefill"]
        else:
            steps, cache = rec["decode_bytes"], rec["cache_bytes_decode"]
        for got in steps:
            assert {names[k]: v for k, v in got.items()} == want, (rank, got)
        assert cache == dry["argument_bytes_by_tree"]["cache"], rank

