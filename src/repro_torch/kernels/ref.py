"""Plain torch versions of the kernels (port of ``repro.kernels.ref``):
the sweeps (B1, B2) and the distance tile (B3, ``pairwise_ref``).

These are the ``ref`` side of every kernel-vs-plain comparison: the CPU
tests run them, ``chip_smoke.py`` holds the CUDA kernels against them on the
card, and the engine's ``use_pallas=False`` path calls them on any device.
Inputs are expected prepared the way the kernel wrappers prepare them
(cosine inputs pre-normalized); ``xsq`` optionally passes the points'
squared norms in, so a caller that sweeps many times computes them once.

Top-p follows ``lax.top_k``: values descending, ties to the lower index.
Index tensors are int64, torch's native index type.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _sq(x):
    return torch.sum(x * x, dim=-1)


def _transform(dot, xsq, ysq, mode):
    """The kernels' epilogue on an (m, n) block of dot products."""
    if mode in ("sqeuclidean", "euclidean"):
        d2 = torch.clamp(xsq[:, None] + ysq[None, :] - 2.0 * dot, min=0.0)
        return torch.sqrt(d2) if mode == "euclidean" else d2
    if mode == "dot":
        return -dot
    if mode == "cosine":
        return torch.arccos(torch.clamp(dot, -1.0, 1.0))
    raise ValueError(mode)


def _norms(x, y, xsq, ysq, mode):
    if mode not in ("sqeuclidean", "euclidean"):
        return None, None
    return (_sq(x) if xsq is None else xsq), (_sq(y) if ysq is None else ysq)


def sweep_dist_ref(x, y, mode: str = "sqeuclidean", xsq=None):
    """Distance block (m, n) of the sweep kernels' plain versions: the
    factorized form over one BLAS product ``x @ y.T``.

    modes: sqeuclidean | euclidean | dot (similarity, negated so that larger
    = farther is monotone with distance) | cosine (arccos of cosine sim —
    inputs are expected pre-normalized by the ops wrapper).
    """
    xsq, ysq = _norms(x, y, xsq, None, mode)
    return _transform(x @ y.T, xsq, ysq, mode)


def dot_in_order(x, y):
    """``x @ y.T`` with every entry summed over d in index order, one
    rounded product and one rounded add per step — the B3 kernel's own
    chain.  An entry depends on its two rows only, so a one-column call
    equals the same column of a full tile bit for bit; a BLAS product does
    not promise that (MKL sums a matrix-vector product in another order
    than a matrix product)."""
    out = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[1]):
        out += x[:, k, None] * y[None, :, k]
    return out


def pairwise_ref(x, y, mode: str = "sqeuclidean", xsq=None, ysq=None):
    """Plain version of the B3 distance kernel: the (m, n) distance matrix
    in the factorized form (modes as in ``sweep_dist_ref``; ``xsq``/``ysq``
    optionally pass the squared norms in).

    The dot products are the kernel's chain (``dot_in_order``), on any
    device: each entry depends on its two rows only — the streaming
    core-set's far-point path recomputes one column after each insert and
    relies on it — and on the card the kernel and this version agree bit
    for bit, so a stream decides the same on both paths.  It repeats the
    kernel's arithmetic and is no yardstick of speed: d launches per call
    (``torch.cdist`` is the library call a time is held against).
    """
    xsq, ysq = _norms(x, y, xsq, ysq, mode)
    return _transform(dot_in_order(x, y), xsq, ysq, mode)


def topk_stable(values, p: int):
    """``lax.top_k`` semantics: the p largest values, descending, ties to
    the lower index (a stable descending sort, cut at p)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:p], idx[:p]


def masked_field(min_in, dist_min, mask):
    """Running-min update and the masked (-inf) selection field."""
    new_min = torch.minimum(min_in, dist_min)
    return new_min, torch.where(mask, new_min,
                                torch.full_like(new_min, NEG_INF))


def gmm_update_select_ref(points, centers, min_in, mask,
                          mode: str = "euclidean", xsq=None):
    """Fused GMM round: distance of every point to the (block of) new
    center(s), running min against ``min_in``, and the masked global max +
    argmax (first index on ties).

    Returns (min_out (n,), argmax () int64, max ()).
    """
    d = sweep_dist_ref(points, centers, mode, xsq=xsq).min(dim=1).values
    min_out, masked = masked_field(min_in, d, mask)
    j = torch.argmax(masked)
    return min_out, j, take(masked, j)


def take(x, i):
    """``x[i]`` for a 0-d index tensor without reading ``i`` on the host
    (indexing with a 0-d tensor would copy it to the host first)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def gmm_topb_ref(points, centers, min_in, mask, mode: str = "euclidean",
                 p: int = None, xsq=None):
    """Fused batched GMM round: running min plus the exact global top-p of
    the updated masked field.  Returns (min_out (n,), vals (p,), idx (p,))."""
    p = centers.shape[0] if p is None else p
    d = sweep_dist_ref(points, centers, mode, xsq=xsq).min(dim=1).values
    new_min, masked = masked_field(min_in, d, mask)
    vals, idx = topk_stable(masked, p)
    return new_min, vals, idx


def merge_tiles(tile_vals, tile_idx, p: int):
    """Cross-tile merge of per-tile top-p winners laid out in tile order:
    a stable descending sort keeps equal values in tile order, and each
    tile's winners are already index-ordered on ties, so the first p are
    the exact global top-p with ``lax.top_k`` tie-breaking."""
    vals, sel = topk_stable(tile_vals, p)
    return vals, tile_idx[sel]


def gmm_topb_tiled_ref(points, centers, min_in, mask, mode: str = "euclidean",
                       p: int = None, bn: int = 256, xsq=None):
    """Torch emulation of the CUDA kernel's tiling: the field is cut into
    ``bn``-row tiles (the ragged last tile padded with -inf rows whose
    indices run past n), each tile keeps its local top-p, and the wrapper's
    ``merge_tiles`` combines them.  Equal to ``gmm_topb_ref`` by
    construction; the tests hold the two against each other."""
    p = centers.shape[0] if p is None else p
    if bn < p:
        raise ValueError(f"tile rows bn={bn} < p={p}")
    n = points.shape[0]
    d = sweep_dist_ref(points, centers, mode, xsq=xsq).min(dim=1).values
    new_min, masked = masked_field(min_in, d, mask)
    tiles = -(-n // bn)
    pad = tiles * bn - n
    field = torch.cat([masked, masked.new_full((pad,), NEG_INF)])
    ids = torch.arange(tiles * bn, device=points.device)
    tv, ti = torch.sort(field.view(tiles, bn), dim=1, descending=True,
                        stable=True)
    ti = torch.gather(ids.view(tiles, bn), 1, ti)
    vals, idx = merge_tiles(tv[:, :p].reshape(-1), ti[:, :p].reshape(-1), p)
    return new_min, vals, torch.clamp(idx, max=n - 1)
