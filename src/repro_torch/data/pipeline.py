"""Data pipeline (port of ``repro.data.pipeline``): deterministic synthetic
streams, the reference's numpy draws from the same seeds, returned as
tensors on the device (default: the card; a missing card raises).

* LM token batches — a stateless function of (seed, step), so a resumed
  run replays the identical data order;
* the paper's point clouds (§7): the "sphere" distribution (k far points on
  the unit sphere plus bulk uniform in a 0.8-radius ball) and a clustered
  mixture.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.vlm import D_VISION


def _on(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def lm_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int,
             t_enc: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Synthetic next-token batch for any family."""
    rng = np.random.default_rng((seed, step))
    V = cfg.vocab_size
    i32 = torch.int32
    if cfg.family == "encdec":
        frames = rng.normal(size=(batch, t_enc or seq, cfg.d_model)) \
            .astype(np.float32)
        toks = rng.integers(0, V, size=(batch, seq + 1))
        return {"frames": _on(frames, device),
                "dec_tokens": _on(toks[:, :-1], device, i32),
                "labels": _on(toks[:, 1:], device, i32)}
    if cfg.family == "vlm":
        pe = rng.normal(size=(batch, cfg.num_patches, D_VISION)) \
            .astype(np.float32)
        toks = rng.integers(0, V, size=(batch, seq + 1))
        return {"tokens": _on(toks[:, :-1], device, i32),
                "patch_embeds": _on(pe, device),
                "labels": _on(toks[:, 1:], device, i32)}
    toks = rng.integers(0, V, size=(batch, seq + 1))
    return {"tokens": _on(toks[:, :-1], device, i32),
            "labels": _on(toks[:, 1:], device, i32)}


# -- paper workloads ---------------------------------------------------------

def sphere_dataset(n: int, k: int, dim: int = 3, seed: int = 0,
                   inner_radius: float = 0.8, device=None) -> torch.Tensor:
    """Paper §7: k points on the unit sphere (the planted diverse set) + the
    rest uniform in the concentric ``inner_radius`` ball."""
    rng = np.random.default_rng(seed)
    far = rng.normal(size=(k, dim))
    far /= np.linalg.norm(far, axis=1, keepdims=True)
    bulk = rng.normal(size=(n - k, dim))
    bulk /= np.linalg.norm(bulk, axis=1, keepdims=True)
    radii = inner_radius * rng.uniform(size=(n - k, 1)) ** (1.0 / dim)
    bulk = bulk * radii
    pts = np.concatenate([far, bulk], axis=0).astype(np.float32)
    rng.shuffle(pts)
    return _on(pts, device)


def clustered_dataset(n: int, clusters: int, dim: int = 8, seed: int = 0,
                      spread: float = 0.05, device=None) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim))
    assign = rng.integers(0, clusters, size=n)
    pts = centers[assign] + spread * rng.normal(size=(n, dim))
    return _on(pts.astype(np.float32), device)


def stream(points, chunk: int) -> Iterator:
    """Consecutive ``chunk``-row slices of ``points`` (array or tensor)."""
    for i in range(0, points.shape[0], chunk):
        yield points[i:i + chunk]
