"""Metric registry (port of ``repro.core.metrics``).

Every metric exposes ``pairwise(x, y) -> (m, n)`` and
``point_to_set(x, c) -> (n,)`` on torch tensors, on whatever device the
inputs share.  ``pairwise`` also takes batches, ``(..., m, d)`` against
``(..., n, d)`` -> ``(..., m, n)``, one batched product (the serving
path's per-request slate matrices).  The euclidean family keeps the factorized
``||x||² + ||y||² − 2x·y`` form clamped at 0, and cosine the ``1e-30``
normalization floor, so values match the reference's.  ``sqeuclidean`` is
not a metric (ordering only) and must not be fed to SMM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Metric:
    name: str
    pairwise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    point_to_set: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # True when pairwise obeys the triangle inequality (SMM requirement).
    is_metric: bool = True


def _sq_norms(x):
    return torch.sum(x * x, dim=-1)


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-30)


def _sqeuclidean_pairwise(x, y):
    # ||x-y||^2 = ||x||^2 + ||y||^2 - 2 x.y
    xx = _sq_norms(x)[..., :, None]
    yy = _sq_norms(y)[..., None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.transpose(-1, -2)), min=0.0)


def _euclidean_pairwise(x, y):
    return torch.sqrt(_sqeuclidean_pairwise(x, y))


def _sqeuclidean_p2s(x, c):
    d2 = _sq_norms(x) + torch.sum(c * c) - 2.0 * (x @ c)
    return torch.clamp(d2, min=0.0)


def _euclidean_p2s(x, c):
    return torch.sqrt(_sqeuclidean_p2s(x, c))


def _cosine_pairwise(x, y):
    # arccos of cosine similarity -- the paper's distance for musiXmatch (§7).
    sim = torch.clamp(_normalize(x) @ _normalize(y).transpose(-1, -2),
                      -1.0, 1.0)
    return torch.arccos(sim)


def _cosine_p2s(x, c):
    cn = c / torch.clamp(torch.linalg.vector_norm(c), min=1e-30)
    sim = torch.clamp(_normalize(x) @ cn, -1.0, 1.0)
    return torch.arccos(sim)


def _manhattan_pairwise(x, y):
    return torch.cdist(x, y, p=1.0)


def _manhattan_p2s(x, c):
    return torch.sum(torch.abs(x - c[None, :]), dim=-1)


_REGISTRY = {
    "euclidean": Metric("euclidean", _euclidean_pairwise, _euclidean_p2s),
    "sqeuclidean": Metric(
        "sqeuclidean", _sqeuclidean_pairwise, _sqeuclidean_p2s,
        is_metric=False),
    "cosine": Metric("cosine", _cosine_pairwise, _cosine_p2s),
    "manhattan": Metric("manhattan", _manhattan_pairwise, _manhattan_p2s),
}


def get_metric(name) -> Metric:
    if isinstance(name, Metric):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown metric {name!r}; have {sorted(_REGISTRY)}")


def register_metric(metric: Metric) -> None:
    _REGISTRY[metric.name] = metric
