"""Carry engine state and results between the reference and the port.

What crosses over is the engine state, the results and a model's
weights.  ``from_reference`` turns the reference's ``RadiusCertificate``,
``Coreset``/``GeneralizedCoreset`` (of a batch or MapReduce run),
``GroupedCoreset`` (a constrained core-set), ``FairCoreset`` (a constrained
MapReduce union) and ``DiversityResult`` (their arrays read as numpy arrays) into
the port's types, and ``stream_from_reference`` the reference's
``StreamingCoreset.state_dict()`` into a live port stream; ``to_numpy`` goes the other way, to plain numpy arrays and dataclass fields
(for a stream, the ``(arrays, meta)`` pair the reference's
``StreamingCoreset.from_state_dict`` takes).  ``params_from_reference``
and ``params_to_reference`` carry a dense or MoE model's weights between the
reference's parameter tree of numpy arrays and the port's tree of
tensors; ``opt_state_from_reference`` and
``opt_state_to_reference`` carry an ``AdamWState`` or ``AdafactorState``.
Nothing here imports the reference: objects are recognised by their
fields, bf16 arrays by their dtype's name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constrained.coreset import GroupedCoreset
from .constrained.mapreduce import FairCoreset
from .core.adaptive import RadiusCertificate
from .core.coreset import Coreset, GeneralizedCoreset
from .core.smm import StreamingCoreset
from .device import resolve_device
from .device import to_numpy as _host
from .tree import tree_map

_CERT_FIELDS = tuple(f.name for f in dataclasses.fields(RadiusCertificate))


def _tensor(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _cert(obj):
    return RadiusCertificate(**{f: getattr(obj, f) for f in _CERT_FIELDS})


def from_reference(obj, device=None):
    """The port's counterpart of a reference object (None passes through).

    ``RadiusCertificate`` -> ``RadiusCertificate``; ``Coreset`` /
    ``GeneralizedCoreset`` / ``GroupedCoreset`` / ``FairCoreset`` -> the
    port's container with tensors on ``device`` (default: the card; a
    missing card raises — pass ``device="cpu"`` for the CPU) and indices
    as int64; ``DiversityResult`` -> the port's ``DiversityResult`` with
    its solution, value, indices, certificate and core-set converted (no
    plan or telemetry)."""
    if obj is None:
        return None
    if all(hasattr(obj, f) for f in ("kprime", "radius", "scale", "ratio")):
        return _cert(obj)
    device = resolve_device(device)
    if hasattr(obj, "multiplicity") and hasattr(obj, "points"):
        return GeneralizedCoreset(
            points=_tensor(obj.points, device, torch.float32),
            multiplicity=_tensor(obj.multiplicity, device, torch.int32),
            radius=_tensor(obj.radius, device, torch.float32),
            cert=from_reference(obj.cert))
    if hasattr(obj, "group_count") and hasattr(obj, "idx"):
        return GroupedCoreset(
            idx=_tensor(obj.idx, device, torch.int64),
            valid=_tensor(obj.valid, device, torch.bool),
            radius=_tensor(obj.radius, device, torch.float32),
            group_count=_tensor(obj.group_count, device, torch.int32),
            cert=from_reference(obj.cert))
    if all(hasattr(obj, f) for f in ("points", "labels", "valid", "radius")):
        return FairCoreset(points=_tensor(obj.points, device, torch.float32),
                           labels=_tensor(obj.labels, device, torch.int32),
                           valid=_tensor(obj.valid, device, torch.bool),
                           radius=_tensor(obj.radius, device, torch.float32),
                           cert=from_reference(obj.cert))
    if hasattr(obj, "valid") and hasattr(obj, "weights"):
        return Coreset(points=_tensor(obj.points, device, torch.float32),
                       valid=_tensor(obj.valid, device, torch.bool),
                       weights=_tensor(obj.weights, device, torch.int32),
                       radius=_tensor(obj.radius, device, torch.float32),
                       cert=from_reference(obj.cert))
    if hasattr(obj, "solution") and hasattr(obj, "value"):
        from .api import DiversityResult
        ind = obj.indices
        return DiversityResult(
            solution=np.asarray(obj.solution), value=float(obj.value),
            _indices=None if ind is None else np.asarray(ind),
            labels=None if obj.labels is None else np.asarray(obj.labels),
            cert=from_reference(obj.cert),
            coreset=from_reference(obj.coreset, device), telemetry=None,
            plan=None)
    raise TypeError(f"no port counterpart for {type(obj).__name__}")


def stream_from_reference(arrays, meta, device=None,
                          use_pallas="auto") -> StreamingCoreset:
    """The port's ``StreamingCoreset`` resuming a reference stream from its
    ``state_dict()``: ``arrays`` (read as numpy arrays) and ``meta`` as the
    reference wrote them, on ``device`` (default: the card; a missing card
    raises).  The stream goes on where the reference's stopped; fed the
    same chunks, both finalize to the same core-set."""
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    return StreamingCoreset.from_state_dict(arrays, dict(meta),
                                            device=resolve_device(device),
                                            use_pallas=use_pallas)


def to_numpy(obj):
    """Plain numpy/dataclass form of a port object: tensors become numpy
    arrays; containers become dicts of their fields; a certificate is
    returned as is (its fields are host values already); a
    ``StreamingCoreset`` becomes its ``(arrays, meta)`` state in the
    reference's layout, arrays as numpy."""
    if obj is None or isinstance(obj, RadiusCertificate):
        return obj
    if isinstance(obj, torch.Tensor):
        return _host(obj)
    if isinstance(obj, StreamingCoreset):
        arrays, meta = obj.state_dict()
        return {name: _host(a) for name, a in arrays.items()}, meta
    if isinstance(obj, (Coreset, GeneralizedCoreset, GroupedCoreset,
                        FairCoreset)):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if hasattr(obj, "solution") and hasattr(obj, "value"):
        return {"solution": np.asarray(obj.solution),
                "value": float(obj.value),
                "indices": None if obj.indices is None
                else np.asarray(obj.indices),
                "labels": obj.labels, "cert": obj.cert,
                "coreset": to_numpy(obj.coreset)}
    return np.asarray(obj)


# --------------------------------------------------------------------------
# model weights
# --------------------------------------------------------------------------

def _weight_in(a, dtype, device) -> torch.Tensor:
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' type, read by its bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _weight_out(t: torch.Tensor, dtype) -> np.ndarray:
    t = t.detach().cpu()
    if dtype is None or np.dtype(dtype) == np.float32:
        return t.float().numpy()
    dt = np.dtype(dtype)
    if dt.name != "bfloat16":
        raise TypeError(f"weights go out as float32 or bfloat16, not {dt}")
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(dt)


def params_from_reference(tree, cfg, device=None):
    """The port's parameter tree (``models.init_params``'s) holding the
    weights of the reference's parameter tree of any family (``{"embed",
    "final_norm", "layers": {...}, ["head"]}``, the hybrid's ``"lead"`` and
    ``"groups": {"attn", "rec_a", "rec_b"}``, the encoder-decoder's
    ``"encoder"``, ``"decoder"`` and ``"enc_norm"``; arrays read as numpy:
    float32, or a dtype named ``bfloat16``, read by its bits), each leaf
    cast to the dtype the
    model builds it in (``cfg.param_dtype``; the MoE router float32) on
    ``device`` (default: the card; a missing card raises).  bf16 -> f32 ->
    bf16 is exact, so a float32 copy of bf16 weights carries them
    unchanged."""
    from .models import _ported, param_shapes

    _ported(cfg)
    dev = resolve_device(device)
    return tree_map(lambda a, s: _weight_in(a, s.dtype, dev), tree,
                    param_shapes(cfg))


def params_to_reference(params, dtype=None):
    """The reference's parameter tree of the port's ``params``, as numpy
    arrays: float32 (``dtype=None``, exact for bf16 weights), or the
    bfloat16 numpy dtype the caller passes (e.g. ``jax.numpy.bfloat16``),
    filled by its bits.  A float32 leaf (the MoE router) stays float32
    either way, so the round trip is exact."""
    return tree_map(lambda t: _weight_out(
        t, None if t.dtype == torch.float32 else dtype), params)


# --------------------------------------------------------------------------
# optimizer state
# --------------------------------------------------------------------------

def _opt_state_type(obj):
    from .train import AdafactorState, AdamWState
    for cls in (AdamWState, AdafactorState):
        if all(hasattr(obj, f) for f in cls._fields):
            return cls
    raise TypeError(f"not an AdamW or Adafactor state: {type(obj).__name__}")


def opt_state_from_reference(state, device=None):
    """The port's ``AdamWState`` / ``AdafactorState`` of the reference's
    (recognised by its fields; arrays read as numpy), on ``device``
    (default: the card; a missing card raises).  The state is fp32 with an
    int32 step, carried unchanged."""
    cls = _opt_state_type(state)
    dev = resolve_device(device)
    return cls(*(tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev),
                          getattr(state, f)) for f in cls._fields))


def opt_state_to_reference(state):
    """``state`` (the port's optimizer state) with numpy leaves, in the
    same NamedTuple: the reference's ``update`` reads it by its fields."""
    cls = _opt_state_type(state)
    return cls(*(tree_map(_host, getattr(state, f)) for f in cls._fields))
