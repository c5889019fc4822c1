"""Carry engine state and results between the reference and the port.

The system has no weights; what crosses over is the engine state and the
results.  ``from_reference`` turns the reference's ``RadiusCertificate``,
``Coreset``/``GeneralizedCoreset`` and ``DiversityResult`` (their arrays
read as numpy arrays) into the port's types, and ``stream_from_reference``
the reference's ``StreamingCoreset.state_dict()`` into a live port stream;
``to_numpy`` goes the other way, to plain numpy arrays and dataclass fields
(for a stream, the ``(arrays, meta)`` pair the reference's
``StreamingCoreset.from_state_dict`` takes).  Nothing here imports the
reference: objects are recognised by their fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.adaptive import RadiusCertificate
from .core.coreset import Coreset, GeneralizedCoreset
from .core.smm import StreamingCoreset
from .device import to_numpy as _host

_CERT_FIELDS = tuple(f.name for f in dataclasses.fields(RadiusCertificate))


def _tensor(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _cert(obj):
    return RadiusCertificate(**{f: getattr(obj, f) for f in _CERT_FIELDS})


def from_reference(obj, device="cpu"):
    """The port's counterpart of a reference object (None passes through).

    ``RadiusCertificate`` -> ``RadiusCertificate``; ``Coreset`` /
    ``GeneralizedCoreset`` -> the port's container with tensors on
    ``device`` (indices as int64); ``DiversityResult`` -> the port's
    ``DiversityResult`` with its solution, value, indices, certificate and
    core-set converted (no plan or telemetry)."""
    if obj is None:
        return None
    if all(hasattr(obj, f) for f in ("kprime", "radius", "scale", "ratio")):
        return _cert(obj)
    if hasattr(obj, "multiplicity") and hasattr(obj, "points"):
        return GeneralizedCoreset(
            points=_tensor(obj.points, device, torch.float32),
            multiplicity=_tensor(obj.multiplicity, device, torch.int32),
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


def stream_from_reference(arrays, meta, device="cpu",
                          use_pallas="auto") -> StreamingCoreset:
    """The port's ``StreamingCoreset`` resuming a reference stream from its
    ``state_dict()``: ``arrays`` (read as numpy arrays) and ``meta`` as the
    reference wrote them.  The stream goes on where the reference's
    stopped; fed the same chunks, both finalize to the same core-set."""
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    return StreamingCoreset.from_state_dict(arrays, dict(meta),
                                            device=device,
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
    if isinstance(obj, (Coreset, GeneralizedCoreset)):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if hasattr(obj, "solution") and hasattr(obj, "value"):
        return {"solution": np.asarray(obj.solution),
                "value": float(obj.value),
                "indices": None if obj.indices is None
                else np.asarray(obj.indices),
                "labels": obj.labels, "cert": obj.cert,
                "coreset": to_numpy(obj.coreset)}
    return np.asarray(obj)
