"""Plain torch versions of the kernels (port of ``repro.kernels.ref``):
the sweeps (B1, B2), the distance tile (B3, ``pairwise_ref``) and the
grouped sweep of the constrained engine (B4, ``gmm_grouped_topb_ref``).

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


def dot64(x, y):
    """``x @ y.T`` with the B3 and B4 kernels' arithmetic: every dot product
    accumulated in float64 from exact fp32 products and rounded once to
    float32.  Two float64 sums in different orders round to the same
    float32 unless the exact sum lies within float64 rounding (~1e-16
    relative) of an fp32 rounding boundary, so kernel and plain agree bit
    for bit but for such entries (one ulp apart), and an entry depends on
    its two rows only, whatever the shape.  Rows go through in chunks so
    the float64 copies of x and of the block stay at most 2^24 entries."""
    y64 = y.to(torch.float64)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    rows = max(1, (1 << 24) // max(1, y.shape[0], x.shape[1]))
    for s in range(0, x.shape[0], rows):
        out[s:s + rows] = (x[s:s + rows].to(torch.float64) @ y64.T).to(
            torch.float32)
    return out


def pairwise_ref(x, y, mode: str = "sqeuclidean", xsq=None, ysq=None):
    """Plain version of the B3 distance kernel: the (m, n) distance matrix
    in the factorized form (modes as in ``sweep_dist_ref``; ``xsq``/``ysq``
    optionally pass the squared norms in): the float64 product rounded
    once (``dot64``), then the epilogue in float32, one rounded op at a
    time.  On the card the kernel and this version agree bit for bit (see
    ``dot64`` for the exception), so a stream decides the same on both
    paths.  It repeats the kernel's arithmetic and is no yardstick of speed
    (``torch.cdist`` is the library call a time is held against).
    """
    xsq, ysq = _norms(x, y, xsq, ysq, mode)
    return _transform(dot64(x, y), xsq, ysq, mode)


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


def grouped_field(dist, min_in, labels, m: int, p: int):
    """The grouped sweep's epilogue on an (n, m·bc) distance block to the
    flattened ``(m, bc)`` centers: each row's own-group distance (the min
    over its group's bc columns; +inf for a label outside [0, m), so such a
    row keeps ``min_in``), the running min, and every group's top-p of the
    new field over its own rows.  Returns (min_out (n,), vals (m, p'),
    idx (m, p')) with p' = min(p, n); a group with fewer than p' rows ends
    in -inf entries (at the lowest-indexed rows of other groups, the order
    ``lax.top_k`` gives)."""
    n = dist.shape[0]
    bc = dist.shape[1] // m
    lab = labels.to(torch.int64)
    mine = (lab >= 0) & (lab < m)
    own = torch.gather(dist.view(n, m, bc), 1,
                       torch.where(mine, lab, 0).view(n, 1, 1)
                       .expand(n, 1, bc)).view(n, bc).min(dim=1).values
    own = torch.where(mine, own, torch.full_like(own, float("inf")))
    new_min = torch.minimum(min_in, own)
    gids = torch.arange(m, device=dist.device)[:, None]
    masked = torch.where(lab[None, :] == gids, new_min[None, :],
                         torch.full_like(new_min, NEG_INF)[None, :])
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return new_min, vals[:, :p], idx[:, :p]


def grouped_dist_ref(x, y, mode: str = "sqeuclidean", xsq=None):
    """Distance block (m, n) with the B4 kernel's arithmetic, which is B3's
    (``pairwise_ref``: each dot product accumulated in float64 and rounded
    once, the epilogue in float32), so the kernel and this version agree
    bit for bit and an engine run decides the same on both paths."""
    return pairwise_ref(x, y, mode, xsq=xsq)


def gmm_grouped_topb_ref(points, centers, min_in, labels,
                         mode: str = "euclidean", p: int = 8, xsq=None):
    """Plain version of the grouped sweep (B4): points (n, d), centers
    (m, bc, d), min_in (n,), labels (n,) -> (min_out (n,), vals (m, p'),
    idx (m, p')), see ``grouped_field``.  It computes the distance of every
    row to all m·bc centers in one product (``grouped_dist_ref``, the
    kernel's arithmetic) and keeps its own group's block; the kernel
    computes the own block only."""
    m, bc, d = centers.shape
    dist = grouped_dist_ref(points, centers.reshape(m * bc, d), mode,
                            xsq=xsq)
    return grouped_field(dist, min_in, labels, m, p)


def gmm_grouped_topb_tiled_ref(points, centers, min_in, labels,
                               mode: str = "euclidean", p: int = 8,
                               bn: int = 1024, xsq=None):
    """Torch emulation of the B4 kernel's tiling: each ``bn``-row tile keeps
    every group's local top-p, a group with fewer than p rows in the tile
    filling its tail with -inf at the tile's first row, and the wrapper's
    merge (``merge_tiles_grouped``) combines them per group.  Equal to
    ``gmm_grouped_topb_ref`` in values and in the indices of every finite
    entry; the tests hold the two against each other."""
    if bn < p:
        raise ValueError(f"tile rows bn={bn} < p={p}")
    m, bc, d = centers.shape
    n = points.shape[0]
    dist = grouped_dist_ref(points, centers.reshape(m * bc, d), mode,
                            xsq=xsq)
    new_min, _, _ = grouped_field(dist, min_in, labels, m, 1)
    tiles = -(-n // bn)
    lab = torch.cat([labels.to(torch.int64),
                     labels.new_full((tiles * bn - n,), -1).to(torch.int64)])
    field = torch.cat([new_min, new_min.new_full((tiles * bn - n,), NEG_INF)])
    gids = torch.arange(m, device=points.device)[:, None]
    masked = torch.where(lab[None, :] == gids, field[None, :],
                         torch.full_like(field, NEG_INF)[None, :])
    tv, ti = torch.sort(masked.view(m, tiles, bn), dim=2, descending=True,
                        stable=True)
    tv, ti = tv[:, :, :p], ti[:, :, :p]
    first = (torch.arange(tiles, device=points.device) * bn)[None, :, None]
    ti = torch.where(torch.isinf(tv) & (tv < 0), first, ti + first)
    vals, idx = merge_tiles_grouped(tv.reshape(m, -1), ti.reshape(m, -1), p)
    return new_min, vals, idx


def merge_tiles_grouped(tile_vals, tile_idx, p: int):
    """Per-group cross-tile merge of (m, T·p) tile winners laid out in tile
    order (``merge_tiles`` for each group)."""
    vals, sel = torch.sort(tile_vals, dim=1, descending=True, stable=True)
    return vals[:, :p], torch.gather(tile_idx, 1, sel[:, :p])
