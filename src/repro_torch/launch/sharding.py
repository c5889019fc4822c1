"""Per-(arch × shape × mesh) sharding decisions (port of
``repro.launch.sharding``).

``rules_for`` picks the ``ShardingRules``; ``batch_struct`` and
``cache_struct`` give the inputs' and the caches' shapes (``meta``
tensors) and ``PartitionSpec``s for every shape cell; ``named`` turns a
tree of specs into DTensor placements over a ``DeviceMesh``,
``distribute`` places a tree of tensors by them and ``move`` re-places a
tree of DTensors from one spec tree to another (a serving loop prefills
under the prefill cell's rules and decodes under the decode cell's).  A
mesh is read through ``mesh_dim_names`` and ``shape`` alone (a
``DeviceMesh``, or any object with those attributes).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import models as M
from ..configs.shapes import ShapeCell
from ..models.common import ModelConfig, P, ShardingRules
from ..tree import cache_build, tree_leaves, tree_map
from .mesh import data_axes


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def rules_for(cfg: ModelConfig, cell: ShapeCell, mesh) -> ShardingRules:
    sizes = _sizes(mesh)
    daxes = data_axes(mesh)
    batch_axes: Tuple[str, ...] = daxes
    kv_seq = None
    # Batched serving keeps weights resident (no ZeRO-3): fsdp stays for a
    # batch under 2 sequences a data shard, or when the weights split over
    # the model axis alone would pass 6 GB a device (arctic)
    fsdp = "data"
    if cell.kind == "decode":
        tp = sizes.get("model", 1)
        dshards = int(np.prod([sizes[a] for a in daxes]))
        if (cell.global_batch >= 2 * dshards
                and 2 * M.count_params(cfg) / tp <= 6e9):
            fsdp = None
    # the reference's len(mesh.devices): the size of the mesh's first axis
    if cell.kind == "decode" and cell.global_batch < 2 * int(mesh.shape[0]) \
            and cell.global_batch <= 16:
        # long-context single-sequence decode: context parallelism, the KV
        # cache's sequence over the data axes, the batch replicated
        batch_axes = ()
        kv_seq = "data"
    elif cell.kind == "decode" and cfg.attn_shard == "pad_heads":
        # split-KV decode: the cache's sequence over the model axis
        kv_seq = "model"
    return ShardingRules(
        batch=batch_axes,
        seq=None,
        # param head axes split only when the published counts divide TP
        heads="model" if cfg.attn_shard == "heads" else None,
        act_heads="model" if cfg.attn_shard in ("heads", "pad_heads")
        else None,
        kv_heads="model" if cfg.attn_shard == "heads" else None,
        head_dim="model" if cfg.attn_shard == "head_dim" else None,
        d_model=None,
        d_ff="model",
        vocab="model",
        experts="model",
        state="model" if cfg.family == "ssm" else None,
        kv_seq=kv_seq,
        fsdp=fsdp,
    )


def _enc_len(cfg: ModelConfig, cell: ShapeCell) -> int:
    return cell.seq_len // 2


def _text_len(cfg: ModelConfig, cell: ShapeCell) -> int:
    if cfg.family == "vlm":
        return max(cell.seq_len - cfg.num_patches, 1)
    return cell.seq_len


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, cell: ShapeCell, rules: ShardingRules):
    """-> (shapes, specs): ``meta`` tensors and ``PartitionSpec``s of the
    train / prefill batch dict."""
    B = cell.global_batch
    bt = rules.resolve("batch")
    i32 = torch.int32
    if cfg.family == "encdec":
        T, S = _enc_len(cfg, cell), cell.seq_len // 2
        shapes = {"frames": _meta((B, T, cfg.d_model), torch.float32),
                  "dec_tokens": _meta((B, S), i32),
                  "labels": _meta((B, S), i32)}
        specs = {"frames": P(bt, None, None), "dec_tokens": P(bt, None),
                 "labels": P(bt, None)}
    elif cfg.family == "vlm":
        from ..models.vlm import D_VISION
        S = _text_len(cfg, cell)
        shapes = {"tokens": _meta((B, S), i32),
                  "patch_embeds": _meta((B, cfg.num_patches, D_VISION),
                                        torch.float32),
                  "labels": _meta((B, S), i32)}
        specs = {"tokens": P(bt, None), "patch_embeds": P(bt, None, None),
                 "labels": P(bt, None)}
    else:
        S = cell.seq_len
        shapes = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        specs = {"tokens": P(bt, None), "labels": P(bt, None)}
    if cell.kind != "train":
        shapes.pop("labels")
        specs.pop("labels")
    return shapes, specs


def cache_struct(cfg: ModelConfig, cell: ShapeCell, rules: ShardingRules,
                 split_local_global: bool = True):
    """-> (shapes, specs) of the decode / prefill cache."""
    shapes = M.make_cache(cfg, cell.global_batch, cell.seq_len,
                          shapes_only=True, t_enc=_enc_len(cfg, cell),
                          split_local_global=split_local_global)
    specs = M.cache_specs(cfg, rules)
    if isinstance(shapes, dict):
        specs = {k: specs for k in shapes}
    return shapes, specs


def _map(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over the ``PartitionSpec`` leaves of
    ``spec_tree`` (nested dicts and NamedTuples), the structure kept."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: _map(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_map(fn, v, *(getattr(t, f) for t in trees))
                                 for f, v in zip(spec_tree._fields,
                                                 spec_tree)))
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def spec_walk(spec_tree, tree, path: str = ""):
    """(path, spec, leaf) over the ``PartitionSpec`` leaves of
    ``spec_tree`` (nested dicts in sorted key order and NamedTuples), the
    path as ``jax.tree_util.keystr`` writes it."""
    if isinstance(spec_tree, P):
        return [(path, spec_tree, tree)]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree)
                for x in spec_walk(spec_tree[k], tree[k], f"{path}[{k!r}]")]
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return [x for f in spec_tree._fields
                for x in spec_walk(getattr(spec_tree, f), getattr(tree, f),
                                   f"{path}.{f}")]
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``: along each mesh
    dim ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  A tuple entry splits its dim over its axes major to
    minor, which DTensor does in mesh order, so the axes must come in the
    mesh's order.  An axis the mesh lacks, or named twice, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names the axis {a!r}, which "
                                 f"the mesh (axes {names}) lacks")
            if a in seen:
                raise ValueError(f"spec {spec} names the axis {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """The tree of ``spec_tree`` with each ``PartitionSpec`` replaced by
    its placements over ``mesh`` (``placements``)."""
    return _map(lambda s: placements(mesh, s), spec_tree)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors on ``mesh`` placed by ``spec_tree``,
    each rank keeping a copy of its shard of its own full tensor (every
    rank holds the same values; no collective).  A dim that does not
    split evenly over its axes raises, naming the leaf."""
    from torch.distributed.tensor import distribute_tensor

    for path, spec, t in spec_walk(spec_tree, tree):
        pl = placements(mesh, spec)
        for d in range(len(spec)):
            n = int(np.prod([int(mesh.shape[i]) for i, p in enumerate(pl)
                             if p.is_shard(d)]))
            if t.shape[d] % n:
                raise ValueError(f"{path}: dim {d} of size {t.shape[d]} "
                                 f"does not split over {n} ranks ({spec})")
    return _map(lambda spec, t: distribute_tensor(
        t, mesh, list(placements(mesh, spec)), src_data_rank=None),
        spec_tree, tree)


def move(tree, mesh, spec_tree):
    """``tree``'s DTensors (on ``mesh``) re-placed by ``spec_tree``: a
    leaf placed so already is kept; otherwise each dim whose old split the
    new one does not extend (its old mesh dims not a prefix of its new
    ones) is all-gathered over its old mesh dims, then each dim is cut to
    this rank's block of its new split.  The gathers are
    ``distributed.sharded``'s (through pinned host memory under gloo with
    CUDA tensors), counted in ``sharded.BYTES``; the result owns its
    storage.  A dim that does not split evenly raises, naming the leaf."""
    from torch.distributed.tensor import DTensor
    from ..distributed.sharded import AxisComm, _chunk, split_dims

    names = tuple(mesh.mesh_dim_names)
    out = {}
    for path, spec, leaf in spec_walk(spec_tree, tree):
        if getattr(leaf, "device_mesh", None) != mesh:
            raise ValueError(f"{path}: not a DTensor on the mesh")
        new_pl = placements(mesh, spec)
        if tuple(leaf.placements) == new_pl:
            out[path] = leaf
            continue
        old, new = split_dims(leaf.placements), split_dims(new_pl)
        t = src = leaf.to_local()
        for d, m in old.items():
            if new.get(d, [])[:len(m)] != m:
                comm = AxisComm(mesh, [names[i] for i in m])
                t = comm.gather(t.movedim(d, 0)).movedim(0, d)
                old[d] = []
        for d, m in new.items():
            extra = m[len(old.get(d, [])):]
            if extra:
                try:
                    t = _chunk(t, d, mesh, extra)
                except ValueError as e:
                    raise ValueError(f"{path}: {e} ({spec})") from None
        t = t.contiguous()
        if t.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
            t = t.clone()
        out[path] = DTensor.from_local(t, mesh, list(new_pl), run_check=False,
                                       shape=leaf.shape, stride=leaf.stride())
    return cache_build(spec_tree, out)


def init_state(optimizer, params, param_specs):
    """``optimizer``'s state for the DTensor ``params`` placed by
    ``optimizer.state_specs(param_specs)``, built from each rank's local
    shards (no rank holds more than its shard: each leaf of ``init`` on a
    param's shard is the shard of the state's leaf)."""
    from torch.distributed.tensor import DTensor

    mesh = tree_leaves(params)[0].device_mesh
    local = optimizer.init(tree_map(lambda p: p.to_local(), params))
    shapes = optimizer.state_shapes(tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params))

    def wrap(spec, loc, shape):
        return DTensor.from_local(loc, mesh, list(placements(mesh, spec)),
                                  run_check=False, shape=shape.shape,
                                  stride=torch.empty(shape.shape,
                                                     device="meta").stride())
    return _map(wrap, optimizer.state_specs(param_specs), local, shapes)
