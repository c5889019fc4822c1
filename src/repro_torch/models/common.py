"""Shared model substrate (port of ``repro.models.common``): config, param
builders, norms, RoPE, MLPs, and the logical-axis sharding rules.

One structure function (``transformer.build_params``) walked by a builder:
``InitBuilder`` draws the weights (on a device, from a ``torch.Generator``
seeded with an int), ``ShapeBuilder`` makes ``meta`` tensors that allocate
nothing, ``SpecBuilder`` gives each weight's ``PartitionSpec`` under a
``ShardingRules`` (logical axis -> mesh axis), as the reference's does.
The specs place *storage*: ``launch.sharding.named`` turns them into
DTensor placements over a ``DeviceMesh``, and the sharded steps
(``train.step``) gather a weight's other split dims before they compute.
``set_current_mesh`` / ``current_mesh`` carry the mesh the MoE layer's
expert-parallel branch reads, as in the reference.

Tensor parallelism over ``model`` (the counterpart of the reference's
``shard`` constraints, under which GSPMD partitions the products): the
sharded steps set a ``TensorParallel`` (``tensor_parallel``) when the
params' mesh has a ``model`` axis of more than one rank, naming the parts
whose leaves they keep split over it, and the code below computes on
this rank's columns and rows, Megatron's way (``CopyToGroup`` on an input
every rank uses, ``ReduceFromGroup`` on the partial sums):

* ``mlp``: ``glu_mlp`` / ``plain_mlp`` over this rank's ``d_ff`` columns
  of ``w_gate``/``w_up`` and rows of ``w_down``;
* ``vocab``: ``embed_tokens`` looks up the ids in this rank's rows of the
  table (the others zero) and sums over the ranks; ``lm_head`` gives this
  rank's vocab columns of the logits; ``vocab_nll`` is the cross-entropy
  over the split vocab and ``vocab_argmax`` the first global index of the
  row's maximum;
* ``heads``: ``attention`` projects, attends and caches this rank's
  heads, and ``out_project`` sums the ranks' parts;
* ``pad_heads``: no leaf is split; ``attention.attend`` with more than
  one query pads the query heads to ``attn_pad_to``, repeats K/V per
  padded head and attends this rank's block of them, and
  ``out_project`` takes this rank's block of the real heads through its
  rows of ``wo`` and sums the ranks' parts;
* ``head_dim``: ``attention`` projects onto this rank's columns of the
  head dim (``wq``/``wk``/``wv``'s last dim, ``wo``'s rows), exchanges
  RoPE's partner columns, sums the ranks' partial scores and
  ``out_project`` the ranks' parts.

The reference's compiled sharded step (XLA on the CPU, a (2, 2) mesh of
Auto axes, ``lowered.compile().as_text()``) promotes these all-reduces to
fp32 (``clone_promoted``): each rank's product is rounded to bf16, the
parts are summed in fp32 and the sum rounded to bf16 once; the
embedding's sum and the gradients' sums over ``model`` likewise.  The
pair sums so (``wide``, then the operand's dtype), but for the head
input's gradient (``_VocabHead``); a float64 config stays float64.  With no ``TensorParallel`` set (one device, a ``model`` axis of
one rank, no ``model`` axis) every function runs the one-device code.

The numerics follow the reference's compiled graphs op for op: bf16
products stay bf16, ``rms_norm`` and RoPE run in fp32 and cast back, a
Python constant that multiplies a bf16 tensor is rounded to bf16 first (a
weakly typed scalar in JAX), the activations run op by op in bf16, and
``lm_head``'s product is a bf16 product rounded to bf16, then upcast to
fp32 (the reference's graph keeps that rounding, eager or jitted: with it
the reduced transformers' logits equal the reference's; an fp32 product
parted by 4e-3-1.3e-2).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
import types
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention flavour
    rope_theta: float = 10000.0
    window: int = 0                  # >0: sliding-window (local) attention
    local_global_period: int = 0     # gemma2: alternate local/global with this period
    logit_softcap: float = 0.0       # gemma2 final-logit softcap
    attn_softcap: float = 0.0        # gemma2 attention-logit softcap
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    mlp_type: str = "glu"            # glu | plain (starcoder2-style 2-matrix)
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma family: x *= sqrt(d_model)
    # --- MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False # arctic: dense MLP residual in parallel
    moe_dense_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- RG-LRU hybrid (recurrentgemma)
    rnn_width: int = 0
    rnn_block_period: int = 0        # (rec, rec, attn) period = 3
    # --- enc-dec
    num_decoder_layers: int = 0
    # --- vlm
    num_patches: int = 0
    # --- numerics / training
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: str = "dots"              # none | dots | full
    # --- sharding overrides (``launch.sharding.rules_for`` reads them; the
    # compute runs the same GQA path, ``attention.attend``, in every mode)
    attn_shard: str = "heads"
    attn_pad_to: int = 0             # padded head count for pad_heads mode
    # sub-quadratic flag for the long_500k cell
    supports_long_context: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:        # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


class PartitionSpec(tuple):
    """A tensor's placement over named mesh axes (the port of
    ``jax.sharding.PartitionSpec``): one entry a tensor dim, each a mesh
    axis name, a tuple of names (the dim split over those axes, major to
    minor) or None (not split); dims past the last entry are not split.
    As JAX does, an entry of one name is that name and an empty tuple is
    None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""
    batch: Tuple[str, ...] = ("data",)
    seq: Optional[str] = None
    heads: Optional[str] = "model"
    act_heads: Optional[str] = "model"
    kv_heads: Optional[str] = "model"
    head_dim: Optional[str] = None
    d_model: Optional[str] = None
    d_ff: Optional[str] = "model"
    vocab: Optional[str] = "model"
    experts: Optional[str] = "model"
    state: Optional[str] = None
    kv_seq: Optional[str] = None
    fsdp: Optional[str] = "data"

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        return getattr(self, logical)

    def spec(self, *logicals) -> PartitionSpec:
        return PartitionSpec(*[self.resolve(l) for l in logicals])


_CURRENT_MESH: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_current_mesh", default=None)


def set_current_mesh(mesh):
    """Launcher hook: with a mesh set, the MoE layer runs its experts
    sharded over the mesh's ``model`` axis (``moe._moe_mlp_shard_map``);
    None is the one-device path."""
    _CURRENT_MESH.set(mesh)


def current_mesh():
    return _CURRENT_MESH.get()


class TensorParallel(NamedTuple):
    """The ``model`` ranks the sharded step computes over (``comm``, a
    ``distributed.sharded.AxisComm``) and the parts it computes over them:
    those whose leaves it keeps split, and ``pad_heads``, the padded
    activation heads of attention (no leaf split)."""
    comm: Any
    mlp: bool = False
    vocab: bool = False
    heads: bool = False
    head_dim: bool = False
    pad_heads: bool = False


_TP: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_tensor_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Within: the model code computes ``tp``'s parts tensor-parallel
    (None: the one-device code)."""
    token = _TP.set(tp)
    try:
        yield
    finally:
        _TP.reset(token)


def tp_comm(part: str):
    """The ``model`` ranks' ``AxisComm`` when ``part`` (a field of
    ``TensorParallel``) is computed tensor-parallel, else None."""
    tp = _TP.get()
    return tp.comm if tp is not None and getattr(tp, part) else None


def tp_copy(x, part: str):
    """``x``, an input each rank uses for its own part of ``part``: its
    gradient summed over the ranks (``CopyToGroup``)."""
    comm = tp_comm(part)
    if comm is None:
        return x
    from ..distributed.sharded import CopyToGroup
    return CopyToGroup.apply(x, comm)


def tp_sum(y, part: str):
    """``y``, this rank's part of a sum over the ranks of ``part``, summed
    (``ReduceFromGroup``)."""
    comm = tp_comm(part)
    if comm is None:
        return y
    from ..distributed.sharded import ReduceFromGroup
    return ReduceFromGroup.apply(y, comm)


# ---------------------------------------------------------------------------
# param builders
# ---------------------------------------------------------------------------

class Builder:
    """Visitor handed to ``build_params`` implementations."""

    def __call__(self, name: str, shape: Sequence[int],
                 axes: Sequence[Optional[str]], *, scale: float = 1.0,
                 init: str = "normal", dtype=None):
        raise NotImplementedError


class InitBuilder(Builder):
    """Draws every weight from the int seed ``key`` on ``device`` (default
    the card; a missing card raises) as the reference does: normal with
    std = scale/sqrt(shape[0]), drawn in fp32 and cast to the param dtype;
    norms zeros.  Torch's generator is not JAX's, so the values differ from
    the reference's init; weights cross over through ``interop``."""

    def __init__(self, key: int, param_dtype, device=None):
        self._dtype = param_dtype
        self._device = resolve_device(device)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(int(key))

    def __call__(self, name, shape, axes, *, scale=1.0, init="normal",
                 dtype=None):
        dtype = dtype or self._dtype
        if init == "zeros":
            return torch.zeros(tuple(shape), dtype=dtype, device=self._device)
        if init == "ones":
            return torch.ones(tuple(shape), dtype=dtype, device=self._device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        std = scale / math.sqrt(fan_in)
        w = torch.randn(tuple(shape), generator=self._gen,
                        dtype=torch.float32, device=self._device)
        return w.mul_(std).to(dtype)


class SpecBuilder(Builder):
    """Each weight's ``PartitionSpec``: its logical axes resolved by the
    rules."""

    def __init__(self, rules: ShardingRules):
        self._rules = rules

    def __call__(self, name, shape, axes, *, scale=1.0, init="normal",
                 dtype=None):
        return PartitionSpec(*[self._rules.resolve(a) for a in axes])


class ShapeBuilder(Builder):
    """``meta`` tensors of the params' shapes and dtypes (no allocation)."""

    def __init__(self, param_dtype):
        self._dtype = param_dtype

    def __call__(self, name, shape, axes, *, scale=1.0, init="normal",
                 dtype=None):
        return torch.empty(tuple(shape), dtype=dtype or self._dtype,
                           device="meta")


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def wide(x):
    """``x`` where the reference upcasts to fp32: fp32, or float64 kept
    as it is (a float64 config runs in float64 throughout, which the
    full-width gradient witness of ``chip_smoke.py`` evaluates)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = wide(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + wide(gamma))
    return out.to(dt)


def rope_angles(positions, hd: int, theta: float):
    """(cos, sin) of RoPE's fp32 angles for ``positions`` (S,), each
    (S, 1, hd // 2): one computation serves every layer's q and k."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(float(theta), exps)                       # fp32
    ang = positions[..., None].float() * freq                  # (S, half)
    ang = ang[..., None, :]                                    # (S, 1, half)
    return torch.cos(ang), torch.sin(ang)


def rope(x, positions, theta: float, angles=None):
    """x (..., S, H, hd) rotated by ``positions`` (S,), split-half layout,
    angles in fp32 (``angles``: their ``rope_angles``, if made already),
    the result cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    cos, sin = angles if angles is not None else rope_angles(
        positions, x.shape[-1], theta)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``) as the reference computes it:
    forward 1 / (1 + e^-x), one rounding to x's dtype per op; backward
    lax.logistic's rule g (s (1 - s)), finite where e^-x overflows (the
    chain rule through the ops gives 0 * inf there, a NaN)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: forward max(x, 0) +
    log1p(e^-|x|); backward logaddexp's rule, g e^(x - out)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _silu(x):
    # jax.nn.silu's graph: x * sigmoid(x)
    return x * _Logistic.apply(x)


@functools.lru_cache(maxsize=None)
def in_dtype(c: float, dtype) -> float:
    """The Python constant ``c`` rounded to ``dtype``: what JAX multiplies
    a ``dtype`` tensor by when the reference writes ``x * c``."""
    return float(torch.tensor(c, dtype=dtype))


def _gelu_tanh(x):
    # jax.nn.gelu(approximate=True)'s graph, constants and every op in x's
    # dtype: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
    inner = x + in_dtype(0.044715, x.dtype) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(in_dtype(math.sqrt(2 / math.pi),
                                            x.dtype) * inner))
    return x * cdf


def _act(name: str):
    """The activations as the reference's graphs compute them, op by op in
    the activations' dtype (F.silu / F.gelu round once, from fp32, and part
    from the reference by an ulp at about a third of bf16 entries)."""
    return {"silu": _silu, "gelu": _gelu_tanh}[name]


def glu_mlp(x, w_gate, w_up, w_down, act_name: str, rules: ShardingRules):
    """SwiGLU / GeGLU (column -> row split over ``model`` under a
    ``TensorParallel``)."""
    x = tp_copy(x, "mlp")
    h = _act(act_name)(x @ w_gate) * (x @ w_up)
    return tp_sum(h @ w_down, "mlp")


def plain_mlp(x, w_up, w_down, act_name: str, rules: ShardingRules):
    """Classic 2-matrix MLP (starcoder2)."""
    x = tp_copy(x, "mlp")
    return tp_sum(_act(act_name)(x @ w_up) @ w_down, "mlp")


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def embed_tokens(tokens, emb, rules: ShardingRules, scale: bool = False,
                 dtype=torch.bfloat16):
    """The table's rows, scaled for the gemma family, cast to ``dtype``:
    bf16 as in the reference (``forward`` passes the config's dtype, bf16
    in every published config; the reference's cast makes an fp32 config
    fail in its layer scan, where the port runs it in fp32).  A lookup
    through ``F.embedding``, whose backward on the card sums each row's
    gradients in a fixed (sorted) order, so a training step repeats bit
    for bit.  Under a ``TensorParallel`` vocab ``emb`` is this rank's
    rows: the ids outside them look up zeros, and the ranks' rows are
    summed (exact: one of them is not zero)."""
    comm = tp_comm("vocab")
    ids = tokens.long()
    if comm is not None:
        ids = ids - comm.rank * emb.shape[0]
        inside = (ids >= 0) & (ids < emb.shape[0])
        ids = torch.where(inside, ids, 0)
    x = torch.nn.functional.embedding(ids, emb)
    if comm is not None:
        x = tp_sum(torch.where(inside[..., None], x, 0), "vocab")
    if scale:
        x = x * in_dtype(math.sqrt(emb.shape[1]), x.dtype)
    return x.to(dtype)


def lm_head(x, emb_or_head, cfg: ModelConfig, rules: ShardingRules):
    """fp32 logits (..., vocab): the product in the operands' dtype,
    upcast to fp32 (float64 kept in a float64 config), then the softcap.
    Under a ``TensorParallel`` vocab, this rank's vocab columns
    (``_VocabHead``)."""
    comm = tp_comm("vocab")
    if comm is None:
        logits = wide(x @ emb_or_head)
    else:
        logits = wide(_VocabHead.apply(x, emb_or_head, comm))
    return softcap(logits, cfg.logit_softcap)


class _VocabHead(torch.autograd.Function):
    """``x @ w``, ``w`` this rank's vocab columns of the head, ``x`` an
    input every rank of ``comm`` uses (``CopyToGroup``'s place).  The
    backward sums the ranks' parts of ``x``'s gradient from fp32 (float64
    kept) and rounds once, as the one-device product's fp32 accumulation
    rounds it: rounding each rank's part first (the reference's compiled
    step does, its all-reduce promoted) moved the signs of gradients near
    0 (a tenth to a half of a percent of the leaf's largest) against the
    reference's own partition in the norms of reduced granite-moe."""

    @staticmethod
    def forward(ctx, x, w, comm):
        ctx.save_for_backward(x, w)
        ctx.comm = comm
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = ctx.comm.sum(wide(g) @ wide(w).T).to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw, None


class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over a vocab split over ``comm``'s
    ranks, ``logits`` (..., V / n) this rank's columns: the max and the
    sums of exponentials all-reduced, the gold logit picked where it lies
    and summed with them; backward softmax minus one-hot on the local
    columns."""

    @staticmethod
    def forward(ctx, logits, labels, comm):
        V = logits.shape[-1]
        m = comm.max(logits.amax(dim=-1))
        e = torch.exp(logits - m[..., None])
        ids = labels.long() - comm.rank * V
        inside = (ids >= 0) & (ids < V)
        ids = torch.where(inside, ids, 0)
        gold = torch.gather(logits, -1, ids[..., None])[..., 0]
        sg = comm.sum(torch.stack([e.sum(dim=-1),
                                   torch.where(inside, gold, 0)], dim=-1))
        lse = m + torch.log(sg[..., 0])
        ctx.save_for_backward(logits, lse, ids, inside)
        return lse - sg[..., 1]

    @staticmethod
    def backward(ctx, g):
        # logsumexp's gradient as torch computes it, exp(x - lse)
        logits, lse, ids, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, ids[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None


def vocab_nll(logits, labels):
    """The per-token -log softmax of the gold label: ``logsumexp`` minus
    the gold logit, over this rank's vocab columns and the others' under a
    ``TensorParallel`` vocab."""
    comm = tp_comm("vocab")
    if comm is not None:
        return _VocabNLL.apply(logits, labels, comm)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def vocab_argmax(logits, comm=None):
    """The argmax over the last dim of ``logits`` as int32, ``logits`` this
    rank's columns of a vocab split over ``comm``'s ranks (None: whole):
    the ranks' maxima all-reduced, then the least global index at which a
    rank holds that maximum, ``torch.argmax``'s first index on the whole
    row."""
    if comm is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    V = logits.shape[-1]
    local = logits.amax(dim=-1)
    top = comm.max(local)
    idx = torch.argmax(logits, dim=-1) + comm.rank * V
    idx = torch.where(local == top, idx, torch.iinfo(torch.int64).max)
    return (-comm.max(-idx)).to(torch.int32)


def unbind_layers(tree, n: int):
    """The ``n`` layers of a dict of stacked ``(n, ...)`` weights, each a
    namespace of views made by one ``unbind`` of each leaf, whose
    backward stacks the layers' gradients once (indexing a layer out of
    the leaf would make a full-size zero gradient a layer)."""
    cols = {k: w.unbind(0) for k, w in tree.items()}
    return [types.SimpleNamespace(**{k: c[i] for k, c in cols.items()})
            for i in range(n)]


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """Save the matrix products without batch dimensions (the projections
    and MLP products: ``mm``, or ``bmm`` over a batch of one, which is what
    ``einsum`` makes of them); recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default
                                 and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(cfg: ModelConfig):
    """The selective-checkpoint policy of ``cfg.remat``: None for ``none``
    (nothing recomputed) and ``full`` (nothing saved), the product-saving
    policy for ``dots`` (the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat={cfg.remat!r}: none | dots | full")
    return _save_dots if cfg.remat == "dots" else None


def maybe_remat(fn, cfg: ModelConfig):
    """``fn`` run under ``torch.utils.checkpoint`` (non-reentrant) as
    ``cfg.remat`` asks: its activations are recomputed in the backward
    pass, all of them (``full``) or all but the saved products (``dots``);
    ``none`` returns ``fn``."""
    policy = remat_policy(cfg)
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def run(*args):
        kw = {} if policy is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
        mesh, tp = current_mesh(), _TP.get()

        def again(*a):
            # the recompute runs in the backward pass, on the autograd
            # engine's thread on the card, outside this context: it sees
            # the mesh and the tensor parallelism the forward saw
            token, tp_token = _CURRENT_MESH.set(mesh), _TP.set(tp)
            try:
                return fn(*a)
            finally:
                _TP.reset(tp_token)
                _CURRENT_MESH.reset(token)
        return checkpoint(again, *args, use_reentrant=False, **kw)
    return run
