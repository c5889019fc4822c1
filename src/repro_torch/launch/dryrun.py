"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch × shape
× mesh) cell placed on the production meshes, its sharded train,
prefill or decode step traced on ``meta`` tensors, and the paper's own
workload, a 2-round MapReduce GMM core-set of 2^30 x 64 points, traced
on one rank's shard.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paper-cell [--multi-pod] [--batch-b 8]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out results/

It needs no card and no ranks.  ``fake_group`` opens a default process
group of the ``fake`` backend (``torch.testing._internal.distributed.
fake_pg``: every collective returns at once, with its output's shape) of
256 ranks, or 512 with ``--multi-pod``, in this one process, as rank 0;
``launch.mesh.make_production_mesh`` builds the mesh over it.  A cell's
params are ``distribute``d as ``meta`` tensors (no memory); a train
cell's optimizer state is built by ``init_state`` and its batch placed
by ``batch_struct``'s specs, and one call of ``train.make_train_step``'s
step runs unchanged under ``FlopCounterMode``; a prefill cell's batch
and cache (``cache_struct``, gemma2's local/global split cache) are
placed likewise and ``train.make_prefill_step``'s step runs, and a
decode cell's step (``make_decode_step``) takes its ``(B, 1)`` tokens
placed ``P(batch, None)``, the position ``seq_len - 1`` and the cache
under the decode rules (batch-split, split-KV or context-parallel).
Every collective of ``distributed.sharded`` is counted in
``sharded.BYTES`` with the bytes it would move on rank 0.  The reference
lowers and compiles the same cells with XLA; the numbers here are the
port's own, reckoned by its code on ``meta`` tensors: no time, rate or
memory of a device.  The port's steps compute tensor-parallel over
``model`` (the MLPs, the vocab and the attention: its heads under
``attn_shard="heads"``, its head dim under ``"head_dim"``, its padded
activation heads under ``"pad_heads"`` with more than one query;
``train.step``), so a decode step where ``fsdp`` is dropped gathers no
weight; a hybrid's recurrent block and an SSM's projections are still
gathered, and the ``fsdp`` halves where the rules keep them.  ``--no-shard-map-moe``
traces a MoE arch with its
experts gathered on every rank (no current mesh), as the reference's
flag runs its GSPMD dispatch.

A cell where a dim does not split evenly over its axes is reported
invalid (each leaf's path, dim and reason) and not traced.

``analyze`` returns the reference's JSON keys where they have a
counterpart:

* ``flops_per_device``: the products ``FlopCounterMode`` counts on rank
  0 (forward, backward and recompute of a train step; the forward of a
  serve step): the tensor-parallel parts' products over this rank's
  columns and rows, the rest whole (ROADMAP C, Decided differences);
* ``collective_bytes_per_device``: ``all-gather`` (its output),
  ``reduce-scatter`` (its input) and ``all-reduce`` (its buffer; a
  decode step's split-softmax combine is two all-reduces a layer) of
  one step on rank 0 (the tensor-parallel sums and the vocab-parallel
  loss's among the all-reduces), ``collective-permute`` (the bytes a
  rank sends point to point: the ``pad_heads`` context's re-split heads,
  ``head_dim``'s RoPE partner columns), ``all-to-all`` 0 (the port makes
  none), and ``collective_total``;
* ``argument_bytes``: rank 0's local params, optimizer state, batch and
  cache;
* ``params``, ``active_ratio``, ``chips``, ``arch``, ``shape``,
  ``multi_pod``; ``trace_s`` in place of ``compile_s``;
* ``peak_bytes``: an estimate of a traced step's peak, the arguments plus
  the most bytes the step's own ``meta`` storages held at once (each
  storage an op returns added at its first tensor and taken off when its
  last one dies); no allocator rounding, no workspace;
* ``null``: ``bytes_per_device``, ``xla_flops_single_visit``,
  ``xla_bytes_single_visit``, ``collective_single_visit``,
  ``output_bytes`` and ``temp_bytes`` are read from XLA's compiled
  program (its cost analysis, HLO text and buffer assignment), which the
  port does not have.

Importing this module touches no process group and no device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import models as M
from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..configs.shapes import ShapeCell
from ..models.common import ModelConfig, P, set_current_mesh
from .mesh import make_production_mesh, num_chips
from .sharding import (batch_struct, cache_struct, placements, rules_for,
                       spec_walk)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# sharded.BYTES's kinds under the reference's names
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter",
          "collective_permute": "collective-permute"}
_XLA_ONLY = ("bytes_per_device", "xla_flops_single_visit",
             "xla_bytes_single_visit", "collective_single_visit",
             "output_bytes", "temp_bytes")
NO_BF16_POINTS = ("bf16 point storage is a later opt-in of the kernels "
                  "(ROADMAP B, 'Configurations the port does not run yet': "
                  "TF32 and bf16 legs); the card keeps fp32")


# ---------------------------------------------------------------------------
# the fake group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks of the ``fake`` backend
    in this process (rank 0), destroyed on leaving, when
    ``models.common.set_current_mesh`` is reset too, even when the body
    raises.  Raises if a default group is already initialized, or if this
    torch has no fake backend."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized: "
                           "the dry run opens its own fake group")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process-group backend "
                           "(torch.testing._internal.distributed.fake_pg); "
                           "the dry run needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        set_current_mesh(None)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _splits(spec, mesh) -> list:
    """Ranks splitting each dim of a leaf placed by ``spec`` on ``mesh``."""
    pl = placements(mesh, spec)
    sizes = [int(s) for s in mesh.shape]
    return [int(np.prod([sizes[i] for i, p in enumerate(pl)
                         if p.is_shard(d)])) for d in range(len(spec))]


def place_tree(shapes, specs, mesh) -> Dict[str, Any]:
    """Each leaf of the ``meta`` tree ``shapes`` placed by ``specs`` on
    ``mesh`` (a ``DeviceMesh``, or any object with ``mesh_dim_names``
    and ``shape``): ``local`` path -> this rank's shape, ``bytes`` the
    rank's bytes, ``invalid`` [(path, dim, reason)] of the dims that do
    not split evenly."""
    local, invalid, nbytes = {}, [], 0
    for path, spec, t in spec_walk(specs, shapes):
        n = _splits(spec, mesh)
        shape = []
        for d, (size, k) in enumerate(zip(t.shape, n)):
            if size % k:
                invalid.append((path, d, f"size {size} does not split over "
                                         f"{k} ranks ({spec})"))
            shape.append(size // k)
        local[path] = tuple(shape)
        nbytes += int(np.prod(shape, dtype=np.int64)) * t.element_size()
    return {"local": local, "bytes": nbytes, "invalid": invalid}


def _decode_tokens(cell: ShapeCell, rules):
    bt = rules.resolve("batch")
    return ({"tokens": torch.empty((cell.global_batch, 1), dtype=torch.int32,
                                   device="meta")},
            {"tokens": P(bt, None)})


def cell_structs(cfg: ModelConfig, cell: ShapeCell, rules) -> Dict[str, Any]:
    """name -> (``meta`` shapes, specs) of what a rank holds in the cell:
    the params, and the optimizer state and batch (train), the batch and
    cache (prefill) or the tokens and cache (decode)."""
    from ..train import default_optimizer

    pshapes, pspecs = M.param_shapes(cfg), M.param_specs(cfg, rules)
    out = {"params": (pshapes, pspecs)}
    if cell.kind == "train":
        opt = default_optimizer(cfg)
        out["opt_state"] = (opt.state_shapes(pshapes),
                            opt.state_specs(pspecs))
        out["batch"] = batch_struct(cfg, cell, rules)
        return out
    out["batch"] = (batch_struct(cfg, cell, rules) if cell.kind == "prefill"
                    else _decode_tokens(cell, rules))
    out["cache"] = cache_struct(cfg, cell, rules)
    return out


def place_cell(cfg: ModelConfig, cell: ShapeCell, mesh) -> Dict[str, Any]:
    """The cell's rules, ``cell_structs`` and each of its trees placed
    on ``mesh`` (``place_tree``); needs no process group."""
    rules = rules_for(cfg, cell, mesh)
    structs = cell_structs(cfg, cell, rules)
    trees = {name: place_tree(shapes, specs, mesh)
             for name, (shapes, specs) in structs.items()}
    invalid = [(f"{name}{path}", d, why) for name, t in trees.items()
               for path, d, why in t["invalid"]]
    return {"rules": rules, "structs": structs, "trees": trees,
            "invalid": invalid,
            "argument_bytes": sum(t["bytes"] for t in trees.values())}


# ---------------------------------------------------------------------------
# the traced train step
# ---------------------------------------------------------------------------

class _PeakMeter(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes of the storages the ops under it return, live and at most at
    once: a storage counts from its first tensor until its last one dies
    (``weakref.finalize``); the storages of ``known`` tensors (the
    arguments) do not count.  An estimate: no allocator rounding, no
    workspace, no caching."""

    def __init__(self, known=()):
        super().__init__()
        self._known = {t.untyped_storage()._cdata for t in known}
        self._live = {}              # storage -> [bytes, tensors]
        self.now = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if type(t) is torch.Tensor:
                self._track(t)
        return out

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key in self._known:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.now += entry[0]
            self.peak = max(self.peak, self.now)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self._live[key]
        entry[1] -= 1
        if not entry[1]:
            del self._live[key]
            self.now -= entry[0]


def _collectives() -> Dict[str, int]:
    """``distributed.sharded.BYTES`` under the reference's names, every
    kind present."""
    from ..distributed import sharded

    out = dict.fromkeys(_COLLECTIVES, 0)
    for kind, n in sharded.BYTES.items():
        out[KINDS[kind]] += n
    return out


@dataclasses.dataclass
class CellTrace:
    """What one cell's dry run found (``analyze`` reads it)."""
    placed: Dict[str, Any]
    flops: Optional[float] = None
    collective: Optional[Dict[str, int]] = None
    peak_bytes: Optional[int] = None
    null_reason: Optional[str] = None


def _trace_train(cfg, mesh, placed, accum_steps: int):
    """One sharded train step of the cell ``placed`` (``place_cell``) on
    ``meta`` tensors: (FLOPs, collective bytes by kind, peak estimate)."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..distributed import sharded
    from ..train import default_lr, default_optimizer, make_train_step
    from ..tree import tree_leaves
    from .sharding import distribute, init_state

    rules, structs = placed["rules"], placed["structs"]
    (pshapes, pspecs), (bshapes, bspecs) = structs["params"], structs["batch"]
    params = distribute(pshapes, mesh, pspecs)
    opt = default_optimizer(cfg)
    state = init_state(opt, params, pspecs)
    batch = distribute(bshapes, mesh, bspecs)
    step = make_train_step(cfg, rules, opt, default_lr(cfg),
                           accum_steps=accum_steps)
    args = [t.to_local() for t in tree_leaves(params) + tree_leaves(batch)
            + [x for f in state for x in tree_leaves(f)]]
    sharded.reset()
    with FlopCounterMode(display=False) as flops, _PeakMeter(args) as peak:
        step(params, state, batch, 0)
    return float(flops.get_total_flops()), _collectives(), peak.peak


def _trace_serve(cfg, cell: ShapeCell, mesh, placed):
    """One sharded prefill or decode step of the cell ``placed``
    (``place_cell``) on ``meta`` tensors: (FLOPs, collective bytes by
    kind, peak estimate)."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..distributed import sharded
    from ..train import make_decode_step, make_prefill_step
    from ..tree import cache_items, tree_leaves
    from .sharding import distribute

    rules, structs = placed["rules"], placed["structs"]
    params, batch, cache = (distribute(structs[k][0], mesh, structs[k][1])
                            for k in ("params", "batch", "cache"))
    args = [t.to_local() for t in tree_leaves(params) + tree_leaves(batch)
            + [x for _, x in cache_items(cache)]]
    sharded.reset()
    with FlopCounterMode(display=False) as flops, _PeakMeter(args) as peak:
        if cell.kind == "prefill":
            make_prefill_step(cfg, rules)(params, batch, cache)
        else:
            make_decode_step(cfg, rules)(params, batch["tokens"],
                                         cell.seq_len - 1, cache)
    return float(flops.get_total_flops()), _collectives(), peak.peak


def lower_config(cfg: ModelConfig, cell: ShapeCell, mesh, *,
                 shard_map_moe: bool = True, accum_steps: int = 1):
    """Place one cell of ``cfg`` and ``cell`` on ``mesh`` (a ``DeviceMesh``
    over the open fake group) and trace its train, prefill or decode
    step (with ``shard_map_moe=False`` the MoE experts gathered on every
    rank).  Returns (CellTrace, meta): an invalid placement is reported,
    not traced."""
    meta = {"arch": cfg.arch, "shape": cell.name, "chips": num_chips(mesh),
            "params": M.count_params(cfg),
            "active_ratio": M.active_param_ratio(cfg)}
    t0 = time.perf_counter()
    placed = place_cell(cfg, cell, mesh)
    trace = CellTrace(placed)
    if placed["invalid"]:
        trace.null_reason = "invalid placement"
    else:
        set_current_mesh(mesh if shard_map_moe else None)
        try:
            trace.flops, trace.collective, peak = (
                _trace_train(cfg, mesh, placed, accum_steps)
                if cell.kind == "train" else
                _trace_serve(cfg, cell, mesh, placed))
        finally:
            set_current_mesh(None)
        trace.peak_bytes = placed["argument_bytes"] + peak
    meta["trace_s"] = time.perf_counter() - t0
    return trace, meta


def lower_cell(arch: str, shape: str, mesh, *, remat: Optional[str] = None,
               shard_map_moe: bool = True, accum_steps: int = 1):
    """Place and trace one (arch, shape, mesh) cell (``lower_config`` on
    the arch's published config).  Returns (CellTrace, meta)."""
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape]
    if not applicable(cfg, cell):
        raise SystemExit(f"SKIP {arch}×{shape}: needs sub-quadratic arch")
    return lower_config(cfg, cell, mesh, shard_map_moe=shard_map_moe,
                        accum_steps=accum_steps)


def analyze(trace: CellTrace) -> Dict[str, Any]:
    """The reference's JSON keys of one dry run (see the module's
    docstring for what each holds here and which are ``null``)."""
    placed = trace.placed
    coll = trace.collective
    out = {
        "valid": not placed["invalid"],
        "invalid": [list(x) for x in placed["invalid"]],
        "flops_per_device": trace.flops,
        "collective_bytes_per_device": coll,
        "collective_total": None if coll is None else sum(coll.values()),
        "argument_bytes": placed["argument_bytes"],
        "argument_bytes_by_tree": {k: t["bytes"]
                                   for k, t in placed["trees"].items()},
        "peak_bytes": trace.peak_bytes,
        "peak_bytes_is": "an estimate from the meta trace (no allocator "
                         "rounding, no workspace)",
        "null_reason": trace.null_reason,
    }
    out.update(dict.fromkeys(_XLA_ONLY))
    if "rules" in placed:
        out["rules"] = dataclasses.asdict(placed["rules"])
    return out


# ---------------------------------------------------------------------------
# the paper's cell
# ---------------------------------------------------------------------------

def paper_body(shard, mesh, kprime: int, batch_b: int = 0,
               use_pallas="auto"):
    """The reference's ``body`` on this rank's ``shard`` (n, d): GMM(k')
    on the shard (``gmm_batched`` with ``batch_b`` centers a sweep when
    ``batch_b`` > 0), its picks all-gathered over every axis of ``mesh``
    in the mesh's order, and the radius max-reduced.  Returns (gathered
    (chips · k', d) fp32, radius, local picks)."""
    from ..core.gmm import gmm, gmm_batched
    from ..distributed.sharded import AxisComm

    if shard.dtype == torch.bfloat16:
        raise NotImplementedError(NO_BF16_POINTS)
    if batch_b:
        idx, radius, _ = gmm_batched(shard, kprime, b=batch_b,
                                     metric="euclidean",
                                     use_pallas=use_pallas)
    else:
        res = gmm(shard, kprime, metric="euclidean", use_pallas=use_pallas)
        idx, radius = res.idx, res.radius
    comm = AxisComm(mesh, tuple(mesh.mesh_dim_names))
    gathered = comm.gather(shard[idx].to(torch.float32))
    return gathered, comm.max(radius.to(torch.float32)), idx


def sweep_bytes(n: int, d: int, itemsize: int = 4) -> int:
    """The least bytes one sweep moves: the shard read once, the running
    min read and written (fp32)."""
    return n * d * itemsize + 2 * n * 4


def lower_paper_cell(mesh, *, n_points: int = 2 ** 30, dim: int = 64,
                     k: int = 128, kprime: int = 2048, batch_b: int = 0,
                     points_bf16: bool = False):
    """The paper's workload on one rank of ``mesh`` (over the open fake
    group): ``paper_body`` traced on a ``meta`` shard of ``n_points //
    chips`` rows.  Returns (CellTrace, meta): the shard's bytes (halved
    with ``points_bf16``, which the trace keeps fp32: the card has no bf16
    leg), the all-gather's and the max-reduce's bytes, and the sweeps and
    their bytes."""
    from ..distributed import sharded
    from ..obs.trace import RunTrace, activate
    from ..obs.trace import sweep_bytes as model_bytes
    from torch.utils.flop_counter import FlopCounterMode

    chips = num_chips(mesh)
    per = n_points // chips
    itemsize = 2 if points_bf16 else 4
    t0 = time.perf_counter()
    shard = torch.empty((per, dim), dtype=torch.float32, device="meta")
    sharded.reset()
    run = RunTrace(enabled=True)
    with activate(run), FlopCounterMode(display=False) as flops:
        paper_body(shard, mesh, kprime, batch_b, use_pallas=False)
    sweeps = run.counters["bytes_swept"] // model_bytes(per, dim)
    shard_bytes = per * dim * itemsize
    placed = {"trees": {"points": {"bytes": shard_bytes}}, "invalid": [],
              "argument_bytes": shard_bytes}
    trace = CellTrace(placed, flops=float(flops.get_total_flops()),
                      collective=_collectives())
    name = "coreset_mr" if not batch_b else f"coreset_mr_b{batch_b}"
    if points_bf16:
        name += "_bf16"
    meta = {"arch": name, "shape": f"n{n_points}_d{dim}_k{kprime}",
            "chips": chips, "params": 0, "active_ratio": 1.0,
            "shard_rows": per, "shard_bytes": shard_bytes,
            "sweeps": int(sweeps),
            "sweep_bytes": sweep_bytes(per, dim, itemsize),
            "sweeps_bytes": int(sweeps) * sweep_bytes(per, dim, itemsize),
            "trace_s": time.perf_counter() - t0}
    return trace, meta


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_path: Optional[str] = None, batch_b: int = 0,
             points_bf16: bool = False, remat: Optional[str] = None,
             shard_map_moe: bool = True, accum_steps: int = 1
             ) -> Dict[str, Any]:
    """One cell on the production mesh over a fake group of its ranks:
    the JSON record (``analyze`` and the meta), printed and written to
    ``out_path``."""
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if arch == "coreset_mr":
            trace, meta = lower_paper_cell(mesh, batch_b=batch_b,
                                           points_bf16=points_bf16)
        else:
            trace, meta = lower_cell(arch, shape, mesh, remat=remat,
                                     shard_map_moe=shard_map_moe,
                                     accum_steps=accum_steps)
    info = analyze(trace)
    info.update(meta)
    info["multi_pod"] = multi_pod
    info["torch"] = torch.__version__
    print(f"== {arch} × {shape} ({_mesh_name(multi_pod)}) ==")
    print(f"trace: {meta['trace_s']:.1f}s  valid: {info['valid']}")
    for path, d, why in info["invalid"]:
        print(f"  INVALID {path} dim {d}: {why}")
    print(f"argument bytes/device: {info['argument_bytes']:,} "
          f"{info['argument_bytes_by_tree']}")
    if info["flops_per_device"] is None:
        print(f"flops, collectives: null ({info['null_reason']})")
    else:
        print(f"flops/device: {info['flops_per_device']:.3e}  "
              f"peak bytes (estimate): {info['peak_bytes']}")
        print("collectives:", info["collective_bytes_per_device"])
    if out_path:
        with open(out_path, "w") as f:
            json.dump(info, f, indent=1)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description="the dry run on meta tensors "
                                             "over a fake process group")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--paper-cell", action="store_true")
    ap.add_argument("--batch-b", type=int, default=0,
                    help="batched-GMM block for the paper cell")
    ap.add_argument("--points-bf16", action="store_true",
                    help="bf16 point storage for the paper cell (its bytes "
                         "only: the card keeps fp32)")
    ap.add_argument("--remat", default=None, choices=("none", "dots", "full"))
    ap.add_argument("--accum", type=int, default=1,
                    help="micro-batch gradient-accumulation steps")
    ap.add_argument("--no-shard-map-moe", action="store_true",
                    help="the MoE experts gathered on every rank")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.paper_cell:
        run_cell("coreset_mr", "paper", args.multi_pod, args.out,
                 batch_b=args.batch_b, points_bf16=args.points_bf16)
        return
    if args.all:
        ok, failed = [], []
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape, cell in SHAPES.items():
                if not applicable(cfg, cell):
                    print(f"SKIP {arch}×{shape} (full-attention arch)")
                    continue
                out = (f"{args.out}/{arch}_{shape}"
                       f"{'_mp' if args.multi_pod else ''}.json"
                       if args.out else None)
                try:
                    info = run_cell(arch, shape, args.multi_pod, out,
                                    remat=args.remat,
                                    shard_map_moe=not args.no_shard_map_moe)
                except Exception as e:
                    traceback.print_exc()
                    failed.append((arch, shape, repr(e)))
                    continue
                if info["valid"]:
                    ok.append((arch, shape))
                else:
                    failed.append((arch, shape, "invalid placement"))
        print(f"\n{len(ok)} cells OK, {len(failed)} failed")
        for f in failed:
            print("FAILED:", f)
        sys.exit(1 if failed else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape, --paper-cell or --all")
    info = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                    remat=args.remat,
                    shard_map_moe=not args.no_shard_map_moe,
                    accum_steps=args.accum)
    if not info["valid"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
