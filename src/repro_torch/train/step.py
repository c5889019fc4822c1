"""train_step / serve_step factories (port of ``repro.train.step``).

``make_train_step`` returns ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)`` over the reference's parameter tree: the gradients
come from autograd (``torch.autograd.grad``, never ``.grad``), with
optional micro-batch accumulation (the micro-batches' gradients summed
into fp32 zeros, as the reference's scan does; float64 ones in a float64
config) and optional bf16 gradient
compression (the cast the data-parallel path puts on the wire).  The
optimizer writes the new values into the params' and the state's tensors
(see ``optimizer``).  ``metrics`` holds 0-dim tensors, so a step makes no
host read.

When the params are DTensors (placed by ``launch.sharding.named`` over a
``DeviceMesh``, the state likewise by ``optimizer.state_specs``), the step
is the reference's sharded step, run on each rank's local tensors
(``_sharded_step``): every leaf gathered whole at the start but those
kept split over ``model`` (``_kept``: the MoE experts, and when the mesh
has a ``model`` axis of more than one rank the tensor-parallel leaves,
computed on in place under ``common.tensor_parallel``: the MLPs' ``d_ff``,
the vocab of ``embed`` and ``head``, and the attention heads or head dim
where the rules split them; under ``pad_heads`` the attention weights
are whole and the padded activation heads split, ``models.attention``),
the loss of this rank's rows of the batch (its block
over the rules' batch axes), the gradients summed over the batch axes
into each leaf's shard (``distributed.sharded``), and the optimizer on
the shards.  Every data shard holds the same number of
tokens, so the loss, the mean of the shards' token means, is the global
token mean; ``grad_norm`` is global.  The mesh comes from the leaves'
placements; a MoE model reads it through ``common.current_mesh()``, which
the caller sets (``set_current_mesh``), as the reference's launcher does;
with no current mesh the experts are gathered too (the reference's
``--no-shard-map-moe``: its MoE layer runs the one-device dispatch), and
their gradients are sliced back to the shards.

``make_prefill_step`` and ``make_decode_step`` return ``(next tokens,
cache)``.  When the params are DTensors, the cache's leaves are too
(placed by ``launch.sharding`` from ``models.cache_specs`` under the
same rules; a cache placed otherwise raises: ``launch.sharding.move``
re-places it), and the step is the reference's sharded serve step on
each rank's local tensors (``sharded_serve``): the params gathered as
the train step gathers them (the tensor-parallel leaves kept split),
this rank's rows of the tokens (and patches, frames), and the one-device
function on the local cache inside ``attention.local_cache`` and
``common.tensor_parallel``, which computes on the cache's slots and KV
heads where they lie (split-KV and context-parallel decode, ``kv_seq``;
head-split caches, ``kv_heads``, are the tensor-parallel heads; a
``head_dim`` cache is whole in the head dim: K/V's columns are gathered
before the write and each rank attends its own columns; a ``pad_heads``
prefill attends its padded heads).  The
cache leaves split over other mesh axes, an SSM's ``state`` (over
``model``) and a hybrid model's ``state`` and ``conv`` rows (over
``d_ff``), are gathered whole for the step and their shards written
back; every other leaf is written in place.  The tokens come back as this rank's rows of a DTensor placed
``P(batch)``, which the next decode step takes as they are (``[:, None]``
of them; the prefill's, placed by the prefill rules, move with the cache
to the decode rules): under a tensor-parallel vocab each rank takes the
argmax of its columns and the ranks the first global index of the row's
maximum (``common.vocab_argmax``: two all-reduces, no all-gather).
Serving needs no gradient: the serve steps run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import models as M
from ..device import is_dtensor
from ..models.common import (ModelConfig, ShardingRules, TensorParallel,
                             current_mesh, tensor_parallel, vocab_argmax)
from ..tree import (cache_build, cache_items, tree_items, tree_leaves,
                    tree_map)
from .optimizer import cosine_schedule, get_optimizer


def make_loss(cfg: ModelConfig, rules: ShardingRules):
    def loss(params, batch):
        return M.loss_fn(params, cfg, rules, batch)
    return loss


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``: the tree's tensors are
    differentiated through views that share their storage."""
    xs = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(xs, batch)
    leaves = tree_leaves(xs)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], xs)


def _acc_dtype(x):
    """The micro-batch accumulator's dtype: fp32, as the reference's
    zeros, or float64 for a float64 leaf (a float64 config runs in
    float64 throughout)."""
    return torch.promote_types(x.dtype, torch.float32)


def make_train_step(cfg: ModelConfig, rules: ShardingRules, optimizer,
                    lr_fn: Callable, accum_steps: int = 1,
                    compress_grads: Optional[str] = None):
    if compress_grads not in (None, "bf16"):
        raise ValueError(f"compress_grads={compress_grads!r}: None | 'bf16'")
    loss_fn = make_loss(cfg, rules)

    def train_step(params, opt_state, batch, step):
        if any(map(is_dtensor, tree_leaves(params))):
            return _sharded_step(cfg, rules, optimizer, lr_fn, accum_steps,
                                 compress_grads, loss_fn, params, opt_state,
                                 batch, step)
        if accum_steps == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"accum_steps={accum_steps}")
            mb = B // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=_acc_dtype(p), device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = _value_and_grad(loss_fn, params, micro)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(accum_steps), grads)
            loss = loss / accum_steps
        if compress_grads == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16)
                             .to(torch.float32), grads)
        lr = torch.as_tensor(lr_fn(step), dtype=torch.float32)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    return train_step


# the MoE experts' leaves: their dim ndim - 3 (E) stays split over
# ``model`` in the sharded step
_EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
# the tensor-parallel leaves by part: name -> the dim (from the end) split
# over ``model`` (``d_ff``, vocab, heads)
_TP_LEAVES = {
    "mlp": {"w_gate": -1, "w_up": -1, "w_down": -2, "r_gate": -1,
            "r_up": -1, "r_down": -2, "m_gate": -1, "m_up": -1,
            "m_down": -2},
    "vocab": {"embed": -2, "head": -1},
    "heads": {"wq": -2, "wk": -2, "wv": -2, "wo": -3, "xq": -2, "xk": -2,
              "xv": -2, "xo": -3},
    "head_dim": {"wq": -1, "wk": -1, "wv": -1, "wo": -2, "xq": -1, "xk": -1,
                 "xv": -1, "xo": -2},
}


def _name(path: str) -> str:
    """The leaf's own key of the tree path ``path`` (``...['name']``)."""
    return path[path.rindex("[") + 2:-2]


def _model_dims(leaf, dim: int):
    """The mesh dims that split ``leaf``'s dim ``dim`` when that is the
    ``model`` axis alone, else ()."""
    from ..distributed.sharded import split_dims

    names = tuple(leaf.device_mesh.mesh_dim_names or ())
    m = split_dims(leaf.placements).get(dim % leaf.ndim, [])
    return tuple(m) if [names[i] for i in m] == ["model"] else ()


def tensor_parallel_of(items, mesh, rules: ShardingRules):
    """The ``TensorParallel`` of the sharded step on the param leaves
    ``items`` (path, DTensor) over ``mesh`` under ``rules``, or None: when
    the mesh's ``model`` axis has more than one rank, a part with leaves
    is computed tensor-parallel when every leaf of it is split over that
    axis alone along its tensor-parallel dim (the heads under
    ``attn_shard="heads"``, where H and KV divide the axis, or the
    placement raises; the head dim under ``"head_dim"``), and the padded
    heads (``pad_heads``, no leaf) when the rules split the activation
    heads over ``model`` and not the param heads (``attn_shard=
    "pad_heads"``)."""
    from ..distributed.sharded import AxisComm

    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or int(mesh.size(names.index("model"))) == 1:
        return None
    on = {}
    for part, dims in _TP_LEAVES.items():
        leaves = [(leaf, dims[_name(p)]) for p, leaf in items
                  if _name(p) in dims]
        on[part] = bool(leaves) and all(_model_dims(l, d) for l, d in leaves)
    on["pad_heads"] = rules.act_heads == "model" and rules.heads is None
    if not any(on.values()):
        return None
    return TensorParallel(AxisComm(mesh, ("model",)), **on)


def _kept(path: str, leaf, tp: Optional[TensorParallel]):
    """The mesh dims of ``leaf`` that the sharded step keeps split: the
    ``model`` dim of a leaf of a part ``tp`` computes tensor-parallel, and
    an expert leaf's expert dim while a mesh is current (else every dim
    is gathered)."""
    name = _name(path)
    for part, dims in _TP_LEAVES.items():
        if name in dims and tp is not None and getattr(tp, part):
            return _model_dims(leaf, dims[name])
    if current_mesh() is None or name not in _EXPERT_LEAVES:
        return ()
    edim = leaf.ndim - 3
    return tuple(i for i, pl in enumerate(leaf.placements)
                 if pl.is_shard(edim))


def _batch_axes(rules: ShardingRules):
    bt = rules.resolve("batch")
    return () if bt is None else (bt,) if isinstance(bt, str) else tuple(bt)


def _local_rows(x, comm):
    """This rank's rows of a batch leaf: a DTensor's local shard, or block
    ``comm.rank`` of a tensor every rank holds whole."""
    if is_dtensor(x):
        return x.to_local()
    if comm is None:
        return x
    if x.shape[0] % comm.size:
        raise ValueError(f"batch {x.shape[0]} does not split over "
                         f"{comm.size} data shards")
    per = x.shape[0] // comm.size
    return x[comm.rank * per:(comm.rank + 1) * per]


def _mesh_of(items):
    """The mesh of the DTensor leaves ``items`` (path, leaf); a leaf that
    is not a DTensor on it raises."""
    mesh = items[0][1].device_mesh if is_dtensor(items[0][1]) else None
    for path, leaf in items:
        if not is_dtensor(leaf) or leaf.device_mesh != mesh:
            raise ValueError(f"leaf {path!r} is not a DTensor on the params' "
                             f"mesh: every leaf of a sharded step is")
    return mesh


def _keep(items, mesh, tp):
    """path -> the mesh dims each param leaf keeps split (``_kept``); a
    current mesh other than the params' raises."""
    if current_mesh() is not None and current_mesh() != mesh:
        raise ValueError("the current mesh (models.common.set_current_mesh) "
                         "is not the params' mesh")
    return {path: _kept(path, leaf, tp) for path, leaf in items}


def sharded_value_and_grad(loss_fn, params, batch, rules: ShardingRules,
                           accum_steps: int = 1):
    """(global loss, gradient shards) of the sharded step: ``params`` a
    tree of DTensors on one mesh, ``batch`` whole on every rank or placed
    over the batch axes.  The gradient shards are plain tensors shaped as
    the params' local shards.

    With ``accum_steps = a`` each of the ``n`` data shards cuts its rows
    into ``a`` micro-batches, so shard j's micro-batch i holds the global
    rows of block j·a + i (blocks of B/(a·n) rows).  The reference
    reshapes the global batch, so its micro-batch i on shard j holds block
    i·n + j: the same blocks, each a MoE layer's own capacity group, summed
    in another order."""
    from ..distributed.sharded import AxisComm, gather, reduce_grad

    items = tree_items(params)
    mesh = _mesh_of(items)
    tp = tensor_parallel_of(items, mesh, rules)
    keep = _keep(items, mesh, tp)
    axes = _batch_axes(rules)
    comm = AxisComm(mesh, axes) if axes else None
    n_data = comm.size if comm is not None else 1
    xs = {path: gather(leaf, keep[path]).detach().requires_grad_()
          for path, leaf in items}
    tree = _unflatten(params, xs)
    local = {k: _local_rows(v, comm) for k, v in batch.items()}
    rows = next(iter(local.values())).shape[0]
    if rows % accum_steps:
        raise ValueError(f"batch shard {rows} is not a multiple of "
                         f"accum_steps={accum_steps}")
    mb = rows // accum_steps
    acc, loss = None, 0.0
    for i in range(accum_steps):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in local.items()}
        with tensor_parallel(tp):
            l = loss_fn(tree, micro)
            g = torch.autograd.grad(l, list(xs.values()))
        loss = loss + l.detach()
        if accum_steps == 1:
            acc = list(g)
        elif acc is None:
            acc = [x.to(_acc_dtype(x)) for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x)
        del g
    if accum_steps > 1:
        acc = [a.div_(accum_steps) for a in acc]
        loss = loss / accum_steps
    grads = {path: reduce_grad(g, leaf, axes, keep[path]).div_(n_data)
             for (path, leaf), g in zip(items, acc)}
    if comm is not None:
        loss = comm.sum(loss.reshape(1)).reshape(()) / n_data
    return loss, _unflatten(params, grads)


def _unflatten(tree, by_path, path: str = ""):
    """``tree``'s nested dicts with the leaf at each path from
    ``by_path``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, by_path, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return by_path[path]


def _sharded_step(cfg, rules, optimizer, lr_fn, accum_steps, compress_grads,
                  loss_fn, params, opt_state, batch, step):
    """The sharded train step (see the module's docstring)."""
    from torch.distributed.tensor import DTensor
    from ..distributed.sharded import LeafMeans, mesh_sum, replicas

    loss, grads = sharded_value_and_grad(loss_fn, params, batch, rules,
                                         accum_steps)
    if compress_grads == "bf16":
        grads = tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32),
                         grads)
    mesh = tree_leaves(params)[0].device_mesh
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                      / replicas(p) for p, g in zip(tree_leaves(params),
                                                    tree_leaves(grads))])
    gnorm = torch.sqrt(mesh_sum(sq.sum().reshape(1), mesh).reshape(()))
    lr = torch.as_tensor(lr_fn(step), dtype=torch.float32)

    def local(tree):
        return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)

    def wrap(new, old):
        return tree_map(lambda n, o: DTensor.from_local(
            n, o.device_mesh, o.placements, run_check=False, shape=o.shape,
            stride=o.stride()) if is_dtensor(o) else n, new, old)

    state_local = type(opt_state)(*(local(f) for f in opt_state))
    _, new_state = optimizer.update(grads, state_local, local(params), lr,
                                    means=tree_map(LeafMeans, params))
    new_state = type(opt_state)(*(wrap(n, o)
                                  for n, o in zip(new_state, opt_state)))
    return params, new_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# the cache leaves the attention code computes on where they lie (slots
# over ``kv_seq``, KV heads over ``kv_heads``); any other leaf split
# beyond the batch is gathered for the step
_ATTENTION_LEAVES = ("k", "v", "slot_pos", "cross_k", "cross_v")


def _serve_rows(name, x, comm, bdims):
    """This rank's rows of the serve input ``x``: the local shard of a
    DTensor split along dim 0 over the batch axes alone (a DTensor placed
    otherwise raises: ``launch.sharding.move`` re-places it), or block
    ``comm.rank`` of a tensor every rank holds whole.  Rows that do not
    split evenly raise, naming ``name``."""
    from ..distributed.sharded import split_dims

    if is_dtensor(x):
        if split_dims(x.placements) != ({0: sorted(bdims)} if bdims else {}):
            raise ValueError(f"{name} is placed {tuple(x.placements)}, not "
                             f"over the rules' batch axes alone: re-place it "
                             f"(launch.sharding.move)")
        return x.to_local()
    if comm is None:
        return x
    if x.shape[0] % comm.size:
        raise ValueError(f"{name}: batch {x.shape[0]} does not split over "
                         f"{comm.size} data shards")
    per = x.shape[0] // comm.size
    return x[comm.rank * per:(comm.rank + 1) * per]


def sharded_serve(cfg: ModelConfig, rules: ShardingRules, serve_fn, params,
                  inputs, cache):
    """(this rank's rows of the logits, ``cache``) of ``serve_fn(params,
    inputs, cache)`` (a one-device prefill or decode) run as the sharded
    serve step (see the module's docstring): ``params`` and ``cache``
    trees of DTensors on one mesh, the cache placed by
    ``models.cache_specs(cfg, rules)``, ``inputs`` a dict of tensors whole
    on every rank or DTensors placed over the rules' batch axes.  Under a
    tensor-parallel vocab (``tensor_parallel_of``) the logits are this
    rank's rows and its vocab columns.  The cache's leaves are written in
    place and keep their placements.  A cache whose KV heads are split
    while the params' heads are not raises."""
    from ..distributed.sharded import AxisComm, _chunk, gather, split_dims
    from ..launch.sharding import placements
    from ..models.attention import local_cache, shard_of

    items = tree_items(params)
    mesh = _mesh_of(items)
    tp = tensor_parallel_of(items, mesh, rules)
    keep = _keep(items, mesh, tp)
    axes = _batch_axes(rules)
    comm = AxisComm(mesh, axes) if axes else None
    names = tuple(mesh.mesh_dim_names)
    bdims = {names.index(a) for a in axes}
    specs = M.cache_specs(cfg, rules)
    citems = cache_items(cache)
    sitems = cache_items({k: specs for k in cache}
                         if isinstance(cache, dict) else specs)
    whole = set()                    # leaves gathered beyond the batch
    local = {}
    for (path, leaf), (_, spec) in zip(citems, sitems):
        if not is_dtensor(leaf) or leaf.device_mesh != mesh:
            raise ValueError(f"cache leaf {path!r} is not a DTensor on the "
                             f"params' mesh: every leaf of a sharded step is")
        if tuple(leaf.placements) != placements(mesh, spec):
            raise ValueError(
                f"cache leaf {path!r} is placed {tuple(leaf.placements)}, "
                f"the rules place it {spec}: re-place the cache "
                f"(launch.sharding.move)")
        beyond = [d for d, m in split_dims(leaf.placements).items()
                  if not bdims.issuperset(m)]
        if (path.rsplit(".", 1)[-1] in ("k", "v", "cross_k", "cross_v")
                and leaf.ndim - 2 in beyond
                and (tp is None or not tp.heads)):
            raise ValueError(f"cache leaf {path!r} splits its KV heads, the "
                             f"params do not split theirs over 'model'")
        if beyond and path.rsplit(".", 1)[-1] not in _ATTENTION_LEAVES:
            whole.add(path)
            local[path] = gather(leaf, tuple(sorted(bdims)))
        else:
            local[path] = leaf.to_local()
    with torch.no_grad():
        ps = _unflatten(params, {path: gather(leaf, keep[path])
                                 for path, leaf in items})
        rows = {k: _serve_rows(k, v, comm, bdims) for k, v in inputs.items()}
        with local_cache(shard_of(mesh, rules)), tensor_parallel(tp):
            logits, out = serve_fn(ps, rows, cache_build(cache, local))
        for (path, leaf), (_, new) in zip(citems, cache_items(out)):
            if new is local[path] and path not in whole:
                continue                 # written in place
            if path in whole:
                for d, m in split_dims(leaf.placements).items():
                    if not bdims.issuperset(m):
                        new = _chunk(new, d, mesh, m)
            leaf.to_local().copy_(new)
    return logits, cache


def _next_tokens(logits, rules: ShardingRules, params):
    """The argmax of the last position's logits (this rank's rows; its
    vocab columns under a tensor-parallel vocab, of which the ranks take
    the first global index of the maximum) as a DTensor placed
    ``P(batch)`` on the params' mesh."""
    from torch.distributed.tensor import DTensor
    from ..launch.sharding import placements
    from ..models.common import P

    mesh = tree_leaves(params)[0].device_mesh
    tp = tensor_parallel_of(tree_items(params), mesh, rules)
    tok = vocab_argmax(logits[:, -1, :],
                       tp.comm if tp is not None and tp.vocab else None)
    pl = placements(mesh, P(rules.resolve("batch")))
    n = 1
    for i, p in enumerate(pl):
        if p.is_shard():
            n *= int(mesh.size(i))
    return DTensor.from_local(tok, mesh, list(pl), run_check=False,
                              shape=(tok.shape[0] * n,), stride=(1,))


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules):
    def prefill_step(params, batch, cache):
        if any(map(is_dtensor, tree_leaves(params))):
            logits, cache = sharded_serve(
                cfg, rules, lambda p, b, c: M.prefill_fn(p, cfg, rules, b, c),
                params, batch, cache)
            return _next_tokens(logits, rules, params), cache
        logits, cache = M.prefill_fn(params, cfg, rules, batch, cache)
        # next-token for the serving loop
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: ShardingRules):
    def decode_step(params, tokens, pos, cache):
        if any(map(is_dtensor, tree_leaves(params))):
            pos = pos.to_local() if is_dtensor(pos) else pos
            logits, cache = sharded_serve(
                cfg, rules, lambda p, b, c: M.decode_fn(
                    p, cfg, rules, b["tokens"], pos, c),
                params, {"tokens": tokens}, cache)
            return _next_tokens(logits, rules, params), cache
        logits, cache = M.decode_fn(params, cfg, rules, tokens, pos, cache)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), cache
    return decode_step


def default_optimizer(cfg: ModelConfig):
    """arctic-class models: adafactor (fp32 params, factored vs); else adamw."""
    if M.count_params(cfg) > 100e9:
        return get_optimizer("adafactor")
    return get_optimizer("adamw")


def default_lr(cfg: ModelConfig, total_steps: int = 10000):
    return cosine_schedule(3e-4, warmup=min(500, total_steps // 10),
                           total=total_steps)
