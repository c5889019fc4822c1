"""Token-choice top-k MoE with capacity-based dispatch (port of
``repro.models.moe``).

Sort-based dropped-token dispatch: each of the N·topk (token, expert)
assignments takes a slot in its expert's buffer of capacity
C = max(int(cf · N · topk / E), min(N, 4) · topk); an assignment whose rank
within its expert, in (token, slot) order, reaches C is dropped (standard
capacity dropping; the floor keeps decode-sized calls free of drops).  The
expert products are batched products over the expert axis (``torch.bmm``,
a batch of E).

No step reads a value back to the host: the dispatch scatters into an
``(E + 1, C + 1, D)`` buffer whose last row and column take the dropped
assignments (at ``(E, C)``, the reference's out-of-range destination) and
slices them off; the combine gathers from the output padded the same way
and masks with ``keep``.  The kept destinations are unique by
construction, so the scatter's backward (a gather) and the combine's
backward (an accumulating scatter) never collide on a kept slot.

The numerics follow the reference's compiled graph (XLA on the CPU, read
from ``jax.jit(...).lower(...).compile().as_text()`` of the reduced
configs' layer and whole forward):

* the router logits are one fp32 product of the bf16-rounded normed
  activations and the fp32 router; the gates are the fp32 softmax of the
  top-k logits, rounded to the activations' dtype;
* every expert product is rounded to bf16, and ``act(gate) * up`` runs op
  by op in bf16 (every rounding survives compilation), as the dense GLU;
* the combine keeps fp32 across the source's bf16 product: the gathered
  rows and the gates, each bf16, are multiplied and summed over the top-k
  slots in fp32 and rounded once;
* arctic's dense residual is added to the MoE output in bf16 (one
  rounding), and that sum joins the residual stream as the dense MLP's
  output does.

``moe_mlp`` runs the single-device path (``_moe_mlp_gspmd``) unless a
mesh with a ``model`` axis is current (``common.set_current_mesh``, as
in the reference), and then expert parallelism (``_moe_mlp_shard_map``,
the reference's ``shard_map`` body): each ``model`` rank dispatches its
data shard's tokens to its own ``E / n_model`` experts
(``_dispatch_local``'s ``E_range``), the capacity C counted from those
local tokens, and the combine sums the ranks' parts.  The layer's input
and the router pass through ``CopyToGroup`` (identity forward, gradient
all-reduced over ``model`` backward: every rank's part depends on them)
and the combine through ``ReduceFromGroup`` (all-reduce forward,
identity backward), Megatron's conjugate pair, which is the transpose of
the ``shard_map``'s replicated inputs.  The code runs on each rank's
local tensors: the tokens are its batch shard, the experts its shard
over ``model``.
"""
from __future__ import annotations

import torch

from .common import ModelConfig, ShardingRules, _act, current_mesh, wide


def capacity(cfg: ModelConfig, N: int) -> int:
    """The experts' buffer rows for ``N`` tokens: a static int, computed
    in Python floats as the reference does."""
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    return max(int(cfg.capacity_factor * N * topk / E), min(N, 4) * topk)


def moe_mlp(x, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
            rules: ShardingRules):
    """x (B, S, D) -> (B, S, D): expert parallelism over the current
    mesh's ``model`` axis when one is set, else the single-device path."""
    mesh = current_mesh()
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        return _moe_mlp_shard_map(x, router_w, w_gate, w_up, w_down, cfg,
                                  rules, mesh)
    return _moe_mlp_gspmd(x, router_w, w_gate, w_up, w_down, cfg, rules)


def _dispatch_local(xf, logits, E_range, cfg: ModelConfig):
    """Capacity-dispatch the tokens ``xf`` (N, D) to the experts
    ``e0 .. e0 + e_loc - 1`` of ``E_range = (e0, e_loc)``.  Returns
    (buf (e_loc, C, D), (keep, dest_e, dest_c, gates, C)): ``keep``,
    ``dest_e`` (``e_loc`` where dropped or not local), ``dest_c`` (``C``
    there) over the N·topk assignments in (token, slot) order, the gates
    (N, topk) in ``xf``'s dtype."""
    N, D = xf.shape
    topk = cfg.num_experts_per_tok
    e0, e_loc = E_range
    dev = xf.device
    top_v, top_i = torch.topk(logits, topk, dim=-1)
    gates = torch.softmax(top_v, dim=-1).to(xf.dtype)

    C = capacity(cfg, N)
    Nk = N * topk
    flat_e = top_i.reshape(Nk) - e0                  # local expert ids
    local = (flat_e >= 0) & (flat_e < e_loc)
    ids = torch.where(local, flat_e, e_loc)
    slots = torch.arange(Nk, device=dev)
    order = torch.argsort(ids * Nk + slots, stable=True)
    sorted_e = ids[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e_loc, device=dev))
    rank_sorted = slots - starts[sorted_e.clamp(max=e_loc - 1)]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = local & (rank < C)
    dest_e = torch.where(keep, flat_e, e_loc)
    dest_c = torch.where(keep, rank, C)
    x_rep = xf.repeat_interleave(topk, dim=0)        # a token a slot
    buf = xf.new_zeros((e_loc + 1, C + 1, D)).index_put(
        (dest_e, dest_c), x_rep)
    return buf[:e_loc, :C], (keep, dest_e, dest_c, gates, C)


def _combine_local(y, meta, N, topk, D):
    """y (e_loc, C, D) -> (N, D): each token's kept rows weighted by its
    gates, summed in fp32 (float64 in a float64 config) and rounded once
    to ``y``'s dtype."""
    keep, dest_e, dest_c, gates, C = meta
    y_tok = torch.nn.functional.pad(y, (0, 0, 0, 1, 0, 1))[dest_e, dest_c]
    y_tok = torch.where(keep[:, None], y_tok, 0)
    out = (wide(y_tok).view(N, topk, D) * wide(gates)[..., None]).sum(1)
    return out.to(y.dtype)


def _expert_ffn(buf, w_gate, w_up, w_down, cfg: ModelConfig):
    """The experts' GLU over their buffers: (E, C, D) -> (E, C, D)."""
    act = _act(cfg.mlp_act)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _moe_mlp_shard_map(x, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
                       rules: ShardingRules, mesh):
    """x (B_loc, S, D) -> (B_loc, S, D) on this rank of ``mesh``: its
    tokens through its experts ``e0 .. e0 + e_loc - 1`` (``e0`` its
    ``model`` coordinate times ``e_loc = E / n_model``), the ranks' parts
    summed over ``model``.  ``w_*`` hold this rank's ``e_loc`` experts."""
    from ..distributed.sharded import AxisComm, CopyToGroup, ReduceFromGroup

    B, S, D = x.shape
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    comm = AxisComm(mesh, ("model",))
    if E % comm.size:
        raise ValueError(f"{E} experts do not split over {comm.size} "
                         f"model ranks")
    e_loc = E // comm.size
    e0 = comm.rank * e_loc
    if w_gate.shape[0] != e_loc:
        raise ValueError(f"the experts' leading dim is {w_gate.shape[0]}, "
                         f"this rank's {e_loc} of {E} expected")
    N = B * S
    xf = CopyToGroup.apply(x.reshape(N, D), comm)
    xw = wide(xf)
    rw = CopyToGroup.apply(router_w, comm)
    logits = xw @ rw.to(xw.dtype)                               # (N, E)
    buf, meta = _dispatch_local(xf, logits, (e0, e_loc), cfg)
    y = _expert_ffn(buf, w_gate, w_up, w_down, cfg)
    out = _combine_local(y, meta, N, topk, D)
    return ReduceFromGroup.apply(out, comm).reshape(B, S, D)


def _moe_mlp_gspmd(x, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
                   rules: ShardingRules):
    """x (B, S, D) -> (B, S, D): the dispatch over the full expert range,
    the experts' products and the combine."""
    B, S, D = x.shape
    N = B * S
    xf = x.reshape(N, D)
    xw = wide(xf)
    logits = xw @ router_w.to(xw.dtype)                         # (N, E)
    buf, meta = _dispatch_local(xf, logits, (0, cfg.num_experts), cfg)
    y = _expert_ffn(buf, w_gate, w_up, w_down, cfg)
    out = _combine_local(y, meta, N, cfg.num_experts_per_tok, D)
    return out.reshape(B, S, D)


def moe_aux_loss(router_logits, top_i, cfg: ModelConfig):
    """Switch-style load-balance auxiliary loss (fraction × probability)."""
    E = cfg.num_experts
    probs = torch.softmax(wide(router_logits), dim=-1)
    me = probs.mean(0)                                          # (E,)
    one_hot = torch.nn.functional.one_hot(top_i[..., 0].long(), E)
    ce = one_hot.to(probs.dtype).mean(0)                        # top-1
    return E * (me * ce).sum()
