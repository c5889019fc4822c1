"""Fused batched-GMM sweep on the card: distance block + running min +
per-tile top-p in one pass, then the cross-tile merge.

Port of ``repro.kernels.gmm_topb.gmm_topb_pallas``; the CUDA body is
``csrc/gmm_sweep.cu`` (see the note there on its bound and design).  A
thread block sweeps a slab of 16 rows of one ``bn``-row tile and keeps
its slab's winners; the last block of a tile to finish merges them into
the tile's top-p (value, index) pairs.  ``sweep_plan`` is the launch the
kernel makes (blocks, warps, scratch), so the grid fills the card at every
n and the CPU tests can read it.  The merge of the
``(n/bn)·p`` tile winners into the exact global top-p stays here, outside
the kernel, as it did in the reference.  The plain version is
``ref.gmm_topb_ref``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import gmm_topb_ref, merge_tiles  # noqa: F401  (plain version)

MODES = {"sqeuclidean": 0, "euclidean": 1, "dot": 2, "cosine": 3}
TILE_ROWS = (256, 512, 1024, 2048, 4096)
SLAB_ROWS = 16                 # rows a block sweeps (csrc/gmm_sweep.cu)


def tile_rows(p: int) -> int:
    """Rows per tile for a top-p sweep: a power of two >= 4p (so a tile
    keeps at most a quarter of its rows as winners), at least 256 and at
    most 4096.  ``p == 1`` takes the 256-row argmax tile."""
    if not 1 <= p <= TILE_ROWS[-1]:
        raise ValueError(f"p={p} out of range 1..{TILE_ROWS[-1]}")
    want = 4 * (1 << (p - 1).bit_length())
    return min(TILE_ROWS[-1], max(TILE_ROWS[0], want))


class SweepPlan(NamedTuple):
    """The grid of one sweep: ``bn`` rows a tile, ``rows`` a block (a slab;
    it divides ``bn``), ``blocks`` blocks, ``tiles`` tiles and ``slab``
    winners a block keeps (min(p, rows)).  The wrapper allocates
    ``blocks·slab`` (value, index) pairs of slab scratch and one ticket a
    tile."""
    bn: int
    rows: int
    blocks: int
    tiles: int
    slab: int


def sweep_plan(n: int, p: int) -> SweepPlan:
    """The grid ``csrc/gmm_sweep.cu`` launches for an n-row sweep at top-p:
    one block a 16-row slab, so the MapReduce probe's 8,192-row sweeps
    launch 512 blocks, 2 or more a multiprocessor (the kernel picks the
    block's warps from b; for b <= 8 four blocks fit a multiprocessor and
    those 512 run in one wave).  n does not change it: the same slab runs
    the 237,662-row main shape at 79 % of its bytes bound on an H100
    (PERF.md)."""
    if n < 1:
        raise ValueError(f"empty sweep n={n}")
    bn, rows = tile_rows(p), SLAB_ROWS
    return SweepPlan(bn, rows, -(-n // rows), -(-n // bn), min(p, rows))


def edge_cases(n: int = 8196, ds=(1, 3, 5000, 5001), bs=(1, 8, 9, 32, 33),
               ps=(1, 32, 128, 4096)):
    """(n, d, b, p) sweeps at the edges of the plan, for holding the kernel
    to its plain version: one row, a slab less or more one row, a tile
    and one row, and ``n`` rows, at each b and p (p <= n), each d."""
    out = []
    for p in ps:
        bn = tile_rows(p)
        for b in bs:
            for m in sorted({1, SLAB_ROWS - 1, SLAB_ROWS + 1, bn + 1, n}):
                out.extend((m, d, b, p) for d in ds if p <= m)
    return out


_TICKETS = {}


def _tickets(device, stream: int, tiles: int):
    """One int32 ticket a tile, zero between launches (the last block of a
    tile resets its own), kept a device and stream."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros((max(tiles, 1024),), dtype=torch.int32,
                          device=device)
        _TICKETS[key] = buf
    return buf


def _check(points, centers, xsq, min_in, mask, mode, p, bn):
    n, d = points.shape
    if centers.ndim != 2 or centers.shape[1] != d:
        raise ValueError(f"centers {tuple(centers.shape)} vs points (n, {d})")
    named = {"points": points, "centers": centers, "min_in": min_in}
    if mode in ("sqeuclidean", "euclidean"):
        if xsq is None:
            raise ValueError(f"mode {mode!r} needs the squared norms xsq")
        named["xsq"] = xsq
    for name, t in named.items():
        if not t.is_cuda or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != points.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{points.device}")
    if min_in.shape != (n,) or (xsq is not None and xsq.shape != (n,)):
        raise ValueError("min_in and xsq must have shape (n,)")
    if mask.shape != (n,) or mask.dtype != torch.bool or not mask.is_cuda \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous (n,) bool CUDA tensor")
    if mode not in MODES:
        raise ValueError(f"no kernel mode {mode!r}")
    if bn not in TILE_ROWS or bn < p:
        raise ValueError(f"tile rows bn={bn} must be one of {TILE_ROWS} "
                         f"and >= p={p}")
    if n >= 2 ** 31 - bn:
        raise ValueError(f"n={n} exceeds the kernel's int32 row indices")


def launch_sweep(points, centers, xsq, min_in, mask, *, mode: str, p: int,
                 bn: int):
    """One launch of the CUDA sweep: returns (min_out (n,), tile_val
    (T·p,), tile_idx (T·p,) int32) with T = ceil(n / bn).  Callers count
    the launch."""
    _check(points, centers, xsq, min_in, mask, mode, p, bn)
    n, d = points.shape
    b = centers.shape[0]
    dev = points.device
    plan = sweep_plan(n, p)._replace(bn=bn, tiles=-(-n // bn))
    csq = torch.sum(centers * centers, dim=-1) if xsq is not None else None
    min_out = torch.empty_like(min_in)
    tile_val = torch.empty((plan.tiles * p,), dtype=torch.float32,
                           device=dev)
    tile_idx = torch.empty((plan.tiles * p,), dtype=torch.int32, device=dev)
    slab_val = torch.empty((plan.blocks * plan.slab,), dtype=torch.float32,
                           device=dev)
    slab_idx = torch.empty((plan.blocks * plan.slab,), dtype=torch.int32,
                           device=dev)
    vec = int(d % 4 == 0 and points.data_ptr() % 16 == 0
              and centers.data_ptr() % 16 == 0)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets(dev, stream, plan.tiles)
        rc = lib.repro_gmm_sweep(
            points.data_ptr(), 0 if xsq is None else xsq.data_ptr(),
            centers.data_ptr(), 0 if csq is None else csq.data_ptr(),
            min_in.data_ptr(), mask.data_ptr(), min_out.data_ptr(),
            tile_val.data_ptr(), tile_idx.data_ptr(), slab_val.data_ptr(),
            slab_idx.data_ptr(), tickets.data_ptr(), n, d, b, p, MODES[mode],
            bn, plan.rows, vec, stream)
    build.check(rc)
    return min_out, tile_val, tile_idx


def gmm_topb_cuda(points, centers, xsq, min_in, mask, *, mode: str,
                  p: int = None, bn: int = None):
    """Fused batched round on the card.  points (n, d), centers (b, d),
    xsq (n,) squared norms (euclidean modes; None otherwise), min_in (n,),
    mask (n,) -> (min_out (n,), cand_val (p,), cand_idx (p,) int64): the
    exact global top-p of the updated masked min-distance field.  Indices
    of the ragged last tile's pad rows run past n (callers clamp)."""
    p = centers.shape[0] if p is None else p
    bn = tile_rows(p) if bn is None else bn
    min_out, tv, ti = launch_sweep(points, centers, xsq, min_in, mask,
                                   mode=mode, p=p, bn=bn)
    build.LAUNCHES["gmm_topb"] += 1
    vals, idx = merge_tiles(tv, ti.long(), p)
    return min_out, vals, idx
