#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # the full run, on one CUDA card

Phases, each printing one JSON line (or one per call):

1. env      — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, TF32 switched off, the kernels built from
              ``src/repro_torch/kernels/csrc`` with nvcc, one process per
              source, all started together (build seconds).
2. kernels  — every CUDA kernel held against its plain torch version on the
              card: modes {sqeuclidean, euclidean, dot, cosine}.  The sweeps
              (B1, B2) at small ragged shapes and the main shape, b in
              {1, 8}, p in {1, 32, 128, 256}; the distance tile (B3) at
              small ragged shapes and the four streaming tile shapes below,
              where a one-column call must equal its tile's column and a
              tail of the rows the tile's rows, bit for bit; the grouped
              sweep (B4) at ragged n, m in {2, 16, 64} groups of 8 centers
              and m = 4 groups of 1, 3 and 9, one empty group, rows
              labelled -1, p in {1, 8, 128, 256}, and at the main shape.
              Values must match to 3e-5; every B4 index must lie in
              [0, n).  B3 and B4 share one arithmetic with their plain
              versions (float64 sums rounded once), so each case also
              counts the entries where kernel and plain differ (expected
              0; a nonzero count is printed, not failed: such an entry is
              a float64 sum within float64 rounding of an fp32 rounding
              boundary, one ulp off).
3. main     — ``repro_torch.diversify`` at the paper's musiXmatch shape
              (237,662 songs x 5,000 words, cosine), synthesized on the card
              from ``--seed``: (a) cosine with default knobs, (b) euclidean
              defaults, (c) ``kprime=64, b=1`` cosine (the gmm_update_select
              path), each with ``use_pallas="auto"`` (the kernels) and
              ``use_pallas=False`` (plain torch); radius, ratio and value
              agree to rtol 1e-4, meets_target and the executed schedule are
              equal, and the kernel launch counters moved on the kernel runs
              only (they are zeroed just before each call); each call runs
              ten times per side in turns kernel, plain, plain, kernel, ...
              (median and spread of the seconds) and must repeat exactly.
4. stream   — ``repro_torch.diversify`` on streaming problems, data made
              on the card from ``--seed``: (a) the musiXmatch shape, cosine,
              remote-edge, k = 128, default knobs (k' = 256, chunk 4,096);
              (b) the same with k' = 1,024; (c) remote-clique (SMM-EXT),
              k = 32, k' = 128; (d) 2^24 points on the unit sphere in 3-D
              (the paper's synthetic streaming set), euclidean, SMM-GEN,
              k = 64, k' = 512, chunk 65,536, fed as a chunk iterator.  Each
              call runs three times per side, kernel and plain in turns; it
              prints seconds, points/s, chunks, far inserts, merges and host
              reads per chunk, and kernel and plain must agree on the
              core-set, d_i, the phase log, the certificate and the picks,
              and on the value to rtol 1e-4.
5. constrained — ``repro_torch.diversify`` on constrained problems at the
              musiXmatch shape, with synthetic "genre" labels over 16 groups
              with Zipf(1) shares made on the card from ``--seed`` (the
              follow-up paper's genre partition; its label file is not in
              the repo): (e) remote-edge, k = 32, labels alone (2 per
              group), default knobs, cosine and euclidean; (f) the same
              with ``kprime=64, b=1``; (g) remote-clique, quotas 2 per
              group, ``kprime=8`` (the delegates pass through B3); three
              calls per side in turns, kernel and plain agreeing on the
              picks and labels, the quotas, the value (rtol 1e-4), the
              per-group radius and certificate, the schedule and every
              counter.  (h) the constrained stream, remote-edge, k = 32,
              quotas 2 per group, k' = 256, chunk 4,096, over the whole
              stream, three calls per side in turns, with the same
              agreement.
6. times    — median kernel and plain times by CUDA events: the sweeps at
              the main shape beside their bytes bound, the grouped sweep
              there (16 groups of 8 centers, p in {1, 128}; 16 groups of one
              center, p = 1; 64 groups at p = 128), the distance tile at the
              streaming shapes beside its
              bound and, for euclidean, ``torch.cdist``'s time (the library
              call; the port never calls it on this path).
7. profile  — device-only torch.profiler traces of batch call (a), stream
              call (b) and constrained call (e) cosine: device time by
              kernel and the device's busy share of that call's wall time
              (full tables in chiprun_out/).

The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero before it.
``--rehearse`` runs phases 2-5 at a tiny size on the CPU with the plain
versions (no build, no timings, no ``ok`` line) to check the script itself.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
FP64_TC_FLOPS = 67e12          # H100 SXM float64 on the tensor cores
TOL = 3e-5                     # kernel parity (reference tests/test_kernels.py)
RTOL_E2E = 1e-4                # end-to-end parity (reference test_kernels.py)
MODES = ("sqeuclidean", "euclidean", "dot", "cosine")
KERNELS = {
    "gmm_topb": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_sweep.cu",
        "replaces": "src/repro/kernels/gmm_topb.py:71"},
    "gmm_update_select": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_sweep.cu",
        "replaces": "src/repro/kernels/gmm_update.py:96"},
    "pairwise": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise.cu",
        "replaces": "src/repro/kernels/pairwise.py:59"},
    "gmm_grouped_topb": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_grouped.cu",
        "replaces": "src/repro/kernels/gmm_update.py:187"},
}
GROUPS = 16                    # synthetic genres of the constrained phase


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def musixmatch_like(n: int, d: int, seed: int, device):
    """Bag-of-words counts shaped like the paper's musiXmatch set: each row
    draws 50-150 words with Zipf(1) rank frequencies over the d words and
    counts them (repeats of frequent words become counts > 1).  Dense
    Gaussian data would be useless here: in 5,000-d its angles all sit near
    pi/2 and the run would be made of near-ties."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    ranks = torch.arange(1, d + 1, dtype=torch.float64, device=device)
    wprob = (1.0 / ranks) / (1.0 / ranks).sum()
    draws = torch.randint(50, 151, (n,), generator=g, device=device)
    dmax = 150
    words = torch.multinomial(wprob.float(), n * dmax, replacement=True,
                              generator=g).view(n, dmax)
    keep = torch.arange(dmax, device=device)[None, :] < draws[:, None]
    rows = torch.arange(n, device=device)[:, None].expand(n, dmax)
    x = torch.zeros((n, d), dtype=torch.float32, device=device)
    x.index_put_((rows[keep], words[keep]),
                 torch.ones((), device=device).expand(int(keep.sum())),
                 accumulate=True)
    return x


def unit_sphere(n: int, seed: int, device):
    """Points uniform on the unit sphere in 3-D, the paper's synthetic
    streaming distribution (benchmarks/bench_streaming.py)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 3), generator=g, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


# --------------------------------------------------------------------------
# phase 2: kernels vs plain
# --------------------------------------------------------------------------

def _close(a, b) -> bool:
    import torch
    return bool(torch.allclose(a, b, rtol=TOL, atol=TOL))


def _err(a, b) -> float:
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def check_pair(x, mode, b, p, gen, errs, label):
    """One (shape, mode, b, p) case: CUDA kernel vs plain on the same
    prepared inputs.  Centers are data rows pushed off the data (so no
    distance sits at the cancellation-prone zero), min_in straddles the
    field so both branches of the running min run."""
    import torch
    from repro_torch.kernels import ops, ref
    n, d = x.shape
    dev = x.device
    rows = torch.randint(0, n, (b,), generator=gen, device=dev)
    cen = x[rows] + torch.rand((b, d), generator=gen, device=dev) * 2.0 - 1.0
    metric = "cosine" if mode == "cosine" else mode
    prep = ops.prepare(x, metric)
    cen_k = ops._normalize(cen) if mode == "cosine" else cen.contiguous()
    scale = ref.pairwise_ref(prep.points, cen_k, mode, xsq=prep.xsq)
    scale = scale.min(dim=1).values
    min_in = scale * (0.5 + torch.rand((n,), generator=gen, device=dev))
    mask = torch.rand((n,), generator=gen, device=dev) > 0.15
    # B2: gmm_update_select (p = 1 by construction)
    if p == 1:
        km, ka, kx = ops.gmm_update_select(prep.points, cen_k, min_in, mask,
                                           metric, xsq=prep.xsq,
                                           prepared=True)
        rm, ra, rx = ref.gmm_update_select_ref(prep.points, cen_k, min_in,
                                               mask, mode, xsq=prep.xsq)
        masked = torch.where(mask, rm, torch.full_like(rm, float("-inf")))
        ok = (_close(km, rm) and _close(kx, rx)
              and _close(ref.take(masked, ka), ref.take(masked, ra)))
        errs["gmm_update_select"] = max(errs["gmm_update_select"],
                                        _err(km, rm), _err(kx, rx))
        if not ok:
            fail(f"gmm_update_select disagrees with plain at {label}")
    # B1: gmm_topb
    km, kv, ki = ops.gmm_topb(prep.points, cen_k, min_in, mask, metric, p=p,
                              xsq=prep.xsq, prepared=True)
    rm, rv, ri = ref.gmm_topb_ref(prep.points, cen_k, min_in, mask, mode, p,
                                  xsq=prep.xsq)
    masked = torch.where(mask, rm, torch.full_like(rm, float("-inf")))
    # index sets are compared through the values they select (exact ties)
    ok = (_close(km, rm) and _close(kv, rv)
          and _close(torch.sort(masked[ki]).values,
                     torch.sort(masked[ri]).values))
    errs["gmm_topb"] = max(errs["gmm_topb"], _err(km, rm), _err(kv, rv))
    if not ok:
        fail(f"gmm_topb disagrees with plain at {label}")


def check_pairwise(x, y, mode, errs, diffs, label):
    """One B3 case: the kernel against its plain version on the same
    prepared rows (float64 sums rounded once on both sides, so they agree
    bit for bit on the card but for sums within float64 rounding of an fp32
    rounding boundary; the stated bound is 3e-5, and ``diffs[label]`` counts
    the entries that differ), a one-column call against its tile's column
    and a tail of the rows against the tile's rows, bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    px, py = ops.prepare(x, mode), ops.prepare(y, mode)
    got = ops.pairwise(px.points, py.points, mode, xsq=px.xsq, ysq=py.xsq,
                       prepared=True)
    want = ref.pairwise_ref(px.points, py.points, mode, xsq=px.xsq,
                            ysq=py.xsq)
    errs["pairwise"] = max(errs["pairwise"], _err(got, want))
    diffs[label] = int((got != want).sum())
    if not _close(got, want):
        fail(f"pairwise disagrees with plain at {label}")
    m, n = x.shape[0], y.shape[0]
    for s in sorted({0, n // 2, n - 1}):
        col = ops.pairwise(px.points, py.points[s:s + 1], mode, xsq=px.xsq,
                           ysq=None if py.xsq is None else py.xsq[s:s + 1],
                           prepared=True)
        if not torch.equal(col[:, 0], got[:, s]):
            fail(f"pairwise one-column call differs from its tile at "
                 f"{label}, column {s}")
    r = m // 3
    tail = ops.pairwise(px.points[r:], py.points, mode,
                        xsq=None if px.xsq is None else px.xsq[r:],
                        ysq=py.xsq, prepared=True)
    if not torch.equal(tail, got[r:]):
        fail(f"pairwise rows from {r} on differ from their tile at {label}")


def check_grouped(x, mode, m, p, gen, errs, diffs, label, bc=8):
    """One B4 case: the grouped sweep against its plain version on the same
    prepared inputs.  Group 1 is empty, ~5 % of the rows are labelled -1
    (they keep min_in and are never candidates), centers are data rows
    pushed off the data, and min_in straddles each row's own-group
    distance.  ``diffs[label]`` counts the min_out and top-p values that
    differ from the plain version's (expected 0, as for B3)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_update import gmm_grouped_topb_cuda
    n, d = x.shape
    dev = x.device
    rows = torch.randint(0, n, (m * bc,), generator=gen, device=dev)
    cen = (x[rows] + torch.rand((m * bc, d), generator=gen, device=dev)
           * 2.0 - 1.0).view(m, bc, d)
    prep = ops.prepare(x, mode)
    cen_k = (ops._normalize(cen) if mode == "cosine" else cen).contiguous()
    labels = torch.randint(0, m, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[labels == 1] = 0
    labels[torch.rand((n,), generator=gen, device=dev) < 0.05] = -1
    inf = torch.full((n,), float("inf"), device=dev)
    own = ref.gmm_grouped_topb_ref(prep.points, cen_k, inf, labels, mode, 1,
                                   xsq=prep.xsq)[0]
    own = torch.where(torch.isinf(own), torch.ones_like(own), own)
    min_in = own * (0.5 + torch.rand((n,), generator=gen, device=dev))
    if x.is_cuda:
        km, kv, ki = gmm_grouped_topb_cuda(prep.points, cen_k, prep.xsq,
                                           min_in, labels, mode=mode, p=p)
    else:
        km, kv, ki = ops.grouped_gmm_topb(prep.points, cen_k, min_in,
                                          labels, mode, p, xsq=prep.xsq,
                                          prepared=True)
    rm, rv, ri = ref.gmm_grouped_topb_ref(prep.points, cen_k, min_in, labels,
                                          mode, p, xsq=prep.xsq)
    field = torch.where(labels[None, :] == torch.arange(
        m, device=dev)[:, None], rm[None, :], float("-inf"))

    def picked(vals, idx):
        # the values an index set selects (exact ties pass); a -inf fill
        # entry selects nothing, its index only has to lie in [0, n)
        return torch.sort(torch.where(torch.isfinite(vals),
                                      torch.gather(field, 1, idx),
                                      float("-inf")), dim=1).values
    ok = (_close(km, rm) and _close(kv, rv)
          and bool(((ki >= 0) & (ki < n)).all())
          and _close(picked(kv, ki), picked(rv, ri)))
    errs["gmm_grouped_topb"] = max(errs["gmm_grouped_topb"], _err(km, rm),
                                   _err(kv, rv))
    q = rv.shape[1]
    diffs[label] = int((km != rm).sum()) + int((kv[:, :q] != rv).sum())
    if not ok:
        fail(f"gmm_grouped_topb disagrees with plain at {label}")


STREAM_TILES = {"chunk": 4096, "caps": (257, 1025, 129),
                "sphere_chunk": 65536, "sphere_cap": 513}
REHEARSAL_TILES = {"chunk": 512, "caps": (9, 65, 17), "sphere_chunk": 4096,
                   "sphere_cap": 65}


def stream_tiles(big, sphere, shapes):
    """The distance tiles the stream calls run: a chunk of rows against
    k'+1 other rows of the same data."""
    m, caps = shapes["chunk"], shapes["caps"]
    far = big.shape[0] // 2
    out = [(f"stream tile {m}x{c}x{big.shape[1]} cosine", big[:m],
            big[far:far + c], "cosine") for c in caps]
    ms, cs = shapes["sphere_chunk"], shapes["sphere_cap"]
    out.append((f"stream tile {ms}x{cs}x3 euclidean", sphere[:ms],
                sphere[-cs:], "euclidean"))
    return out


def phase_kernels(big, seed: int, small_only: bool, tiles=(), out=None):
    import torch
    dev = big.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    errs = dict.fromkeys(KERNELS, 0.0)
    diffs = {"pairwise": {}, "gmm_grouped_topb": {}}
    cases = 0
    t0 = time.perf_counter()
    for n in (33, 1000, 4097):
        for d in (3, 17, 128):
            x = torch.randn((n, d), generator=gen, device=dev)
            for mode in MODES:
                for b in (1, 8):
                    for p in (1, 32, 128, 256):
                        if p <= n:
                            check_pair(x, mode, b, p, gen, errs,
                                       f"n={n} d={d} {mode} b={b} p={p}")
                            cases += 1
    if not small_only:
        for mode in MODES:
            for b in (1, 8):
                for p in (1, 32, 128, 256):
                    check_pair(big, mode, b, p, gen, errs,
                               f"main shape {mode} b={b} p={p}")
                    cases += 1
    # B3: ragged m, n, d (none a multiple of a tile edge; n <= 8 takes the
    # narrow tile, the others the medium and wide ones)
    for m, n, d in ((33, 5, 3), (1000, 129, 17), (4097, 300, 128),
                    (1, 1, 5), (70, 4, 64), (300, 1025, 3), (65, 9, 1),
                    (130, 70, 5000)):
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((n, d), generator=gen, device=dev)
        for mode in MODES:
            check_pairwise(x, y, mode, errs, diffs["pairwise"],
                           f"m={m} n={n} d={d} {mode}")
            cases += 1
    for label, x, y, mode in tiles:
        check_pairwise(x, y, mode, errs, diffs["pairwise"], label)
        cases += 1
    # B4: ragged n, m groups of bc centers (bc = 9 takes two passes of 8),
    # p up to 256
    for n, d in ((1000, 17), (4097, 128)):
        x = torch.randn((n, d), generator=gen, device=dev)
        for mode in MODES:
            for m, bc in ((2, 8), (16, 8), (64, 8), (4, 1), (4, 3), (4, 9)):
                for p in (1, 8, 128, 256):
                    check_grouped(x, mode, m, p, gen, errs,
                                  diffs["gmm_grouped_topb"],
                                  f"n={n} d={d} {mode} m={m} bc={bc} p={p}",
                                  bc=bc)
                    cases += 1
    if not small_only:
        for mode in MODES:
            for m in (2, GROUPS, 64):
                for p in (1, 128):
                    check_grouped(big, mode, m, p, gen, errs,
                                  diffs["gmm_grouped_topb"],
                                  f"main shape {mode} m={m} p={p}")
                    cases += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if out is not None:
        (out / "kernel_differing_entries.json").write_text(
            json.dumps(diffs, indent=1))
    emit({"phase": "kernels", "cases": cases, "tolerance": TOL,
          "max_abs_err": errs,
          "differing_entries": {k: sum(v.values()) for k, v in diffs.items()},
          "cases_with_differing_entries": {
              k: {c: n for c, n in v.items() if n} for k, v in diffs.items()},
          "seconds": time.perf_counter() - t0})
    # every B3 and B4 case with its count (expected 0 each)
    for k, v in diffs.items():
        emit({"phase": "differing_entries", "kernel": k,
              "cases": len(v), "counts": list(v.values())})
    return errs, diffs


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

CALLS = {
    "a_cosine_defaults": (dict(k=16, metric="cosine"), {}),
    "b_euclidean_defaults": (dict(k=16), {}),
    "c_cosine_kprime64_b1": (dict(k=16, metric="cosine"),
                             dict(kprime=64, b=1)),
}


def _run(x, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(x, execution=repro_torch.ExecutionSpec(
        use_pallas=use_pallas, device=device, **knobs), **problem)
    idx = res.indices
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, idx, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _spread(secs):
    return {"median": statistics.median(secs), "min": min(secs),
            "max": max(secs), "all": secs}


def phase_main(x, device, check_launches: bool, pairs: int = 10):
    import numpy as np
    launches = dict.fromkeys(KERNELS, 0)
    kernel_median_s = {}
    # untimed warm-up of both paths: a process's first engine call pays
    # one-time library set-up (~0.1-0.4 s) that would land on whichever
    # side runs first
    for use_pallas in ("auto", False):
        _run(x, *CALLS["a_cosine_defaults"], use_pallas, device)
    order = ("auto", False, False, "auto") * (pairs // 2)
    for name, (problem, knobs) in CALLS.items():
        # `pairs` calls per side in turns (kernel, plain, plain, kernel, ...)
        # so neither side always runs first; the first call of each side is
        # held to the agreement checks, the repeats must reproduce it
        # exactly (no atomics, no data races)
        runs = {"auto": [], False: []}
        for use_pallas in order:
            runs[use_pallas].append(_run(x, problem, knobs, use_pallas,
                                         device))
        (kres, kidx, _, kl), (pres, pidx, _, pl) = runs["auto"][0], \
            runs[False][0]
        for first, idx0, side in ((kres, kidx, "auto"), (pres, pidx, False)):
            for res, idx, _, _ in runs[side][1:]:
                if not (np.array_equal(idx, idx0)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        if any(lc != kl for *_, lc in runs["auto"]):
            fail(f"{name}: kernel launch counts differ between repeats")
        ks = [r[2] for r in runs["auto"]]
        ps = [r[2] for r in runs[False]]
        kc, pc = kres.cert, pres.cert
        row = {"phase": "main", "call": name, "n": int(x.shape[0]),
               "d": int(x.shape[1]), "problem": problem, "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_over_plain_median":
                   statistics.median(ks) / statistics.median(ps),
               "kernel_launches": kl,
               "value": [kres.value, pres.value],
               "coreset_radius": [float(kres.coreset.radius),
                                  float(pres.coreset.radius)],
               "identical_picks": int(len(np.intersect1d(kidx, pidx))),
               "k": len(kidx)}
        close = ["value", "coreset_radius"]
        if kc is not None or pc is not None:    # pinned knobs mint no cert
            row.update({
                "radius": [kc.radius, pc.radius],
                "ratio": [kc.ratio, pc.ratio],
                "meets_target": [kc.meets_target, pc.meets_target],
                "kprime": [kc.kprime, pc.kprime],
                "b_schedule_equal": kc.b_schedule == pc.b_schedule,
                "b_schedule": [list(map(list, kc.b_schedule)),
                               list(map(list, pc.b_schedule))]})
            close += ["radius", "ratio"]
        emit(row)
        for key in close:
            a, b = row[key]
            if not np.isclose(a, b, rtol=RTOL_E2E, atol=0.0):
                fail(f"{name}: {key} kernel {a} vs plain {b}")
        if "radius" in row and (kc.meets_target != pc.meets_target
                                or not row["b_schedule_equal"]):
            fail(f"{name}: meets_target/b_schedule differ")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and len(set(kidx.tolist())) == problem["k"]):
            fail(f"{name}: solution is not k distinct finite rows")
        if any(any(lc.values()) for *_, lc in runs[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches:
            want = "gmm_update_select" if knobs.get("b") == 1 else "gmm_topb"
            if kl[want] <= 0:
                fail(f"{name}: {want} never launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        kernel_median_s[name] = statistics.median(ks)
    return launches, kernel_median_s


# --------------------------------------------------------------------------
# phase 4: the streaming path
# --------------------------------------------------------------------------

def stream_calls(full: bool):
    """(name, data, problem, knobs) of the stream calls; ``full=False`` is
    the rehearsal's tiny size."""
    if full:
        return [
            ("a_cosine_edge_k128", "mxm", dict(k=128, metric="cosine"), {}),
            ("b_cosine_edge_k128_kp1024", "mxm",
             dict(k=128, metric="cosine"), dict(kprime=1024)),
            ("c_cosine_clique_k32_ext", "mxm",
             dict(k=32, metric="cosine", measure="remote-clique"),
             dict(kprime=128)),
            ("d_sphere_gen_k64", "sphere", dict(k=64),
             dict(kprime=512, chunk=65536, smm_mode="gen")),
        ]
    return [
        ("a_cosine_edge", "mxm", dict(k=8, metric="cosine"),
         dict(chunk=512)),
        ("b_cosine_edge_kp64", "mxm", dict(k=8, metric="cosine"),
         dict(kprime=64, chunk=512)),
        ("c_cosine_clique_ext", "mxm",
         dict(k=4, metric="cosine", measure="remote-clique"),
         dict(kprime=16, chunk=512)),
        ("d_sphere_gen", "sphere", dict(k=8),
         dict(kprime=64, chunk=4096, smm_mode="gen")),
    ]


def _stream_source(data, x, chunk):
    """The points as a user streams them: the on-card array with
    ``mode="streaming"`` (musiXmatch shape), or a chunk iterator over the
    on-card sphere points."""
    if data == "mxm":
        return x, {"mode": "streaming"}
    return (x[i:i + chunk] for i in range(0, x.shape[0], chunk)), {}


def _run_stream(x, data, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    src, extra = _stream_source(data, x, knobs["chunk"] if "chunk" in knobs
                                else 4096)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(src, execution=repro_torch.ExecutionSpec(
        use_pallas=use_pallas, device=device, trace=True, **extra, **knobs),
        **problem)
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _near(a, b) -> bool:
    """Floats derived from distances (d_i, the certificate) agree to rtol
    1e-5; kernel and plain compute the same chain, so they are expected
    equal, and the bound only absorbs a last-ulp difference of sqrt/acos."""
    import numpy as np
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and bool(np.allclose(a, b, rtol=1e-5, atol=0))


def _coreset_rows(res):
    """The core-set as host arrays: its points (valid rows, in slot order)
    and, for a generalized one, the multiplicities."""
    from repro_torch.device import to_numpy
    cs = res.coreset
    if hasattr(cs, "multiplicity"):
        m = to_numpy(cs.multiplicity)
        return to_numpy(cs.points)[m > 0], m[m > 0]
    v = to_numpy(cs.valid)
    return to_numpy(cs.points)[v], None


def phase_stream(data, device, check_launches: bool, runs: int = 3,
                 full: bool = True):
    """The stream calls, ``runs`` per side in turns (kernel, plain, plain,
    kernel, ...).  Returns (launches of the first kernel run of each call,
    summed; per-call kernel median seconds)."""
    import numpy as np
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    order = ["auto", False, False, "auto"] * runs
    order = order[:2 * runs]
    for name, kind, problem, knobs in stream_calls(full):
        x = data[kind]
        n = int(x.shape[0])
        out = {"auto": [], False: []}
        for use_pallas in order:
            out[use_pallas].append(_run_stream(x, kind, problem, knobs,
                                               use_pallas, device))
        (kres, _, kl), (pres, _, pl) = out["auto"][0], out[False][0]
        for side in ("auto", False):
            first = out[side][0][0]
            for res, _, lc in out[side][1:]:
                if not (np.array_equal(res.solution, first.solution)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        kc, pc = kres.cert, pres.cert
        (kp, km), (pp, pm) = _coreset_rows(kres), _coreset_rows(pres)
        same_coreset = (kp.shape == pp.shape and np.array_equal(kp, pp)
                        and (km is None or np.array_equal(km, pm)))
        tr = kres.telemetry
        chunk = knobs.get("chunk", 4096)
        chunks = -(-n // chunk)
        ks = [r[1] for r in out["auto"]]
        ps = [r[1] for r in out[False]]
        row = {"phase": "stream", "call": name, "n": n,
               "d": int(x.shape[1]), "problem": problem, "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_points_per_s": n / statistics.median(ks),
               "plain_points_per_s": n / statistics.median(ps),
               "chunks": chunks,
               "far_inserts": tr.counters.get("far_inserts", 0),
               "merges": tr.extras["merges"],
               "host_reads_per_chunk": tr.counters["host_syncs"] / chunks,
               "distance_tiles": tr.counters["device_dispatches"],
               "kernel_launches": kl,
               "coreset_rows": int(kp.shape[0]),
               "agree": {
                   "coreset": bool(same_coreset),
                   "d_thr": _near(float(kres.coreset.radius),
                                  float(pres.coreset.radius)),
                   "phase_log": kc.counts == pc.counts
                   and _near(kc.radii, pc.radii),
                   "certificate": kc.meets_target == pc.meets_target
                   and _near((kc.radius, kc.scale, kc.ratio),
                             (pc.radius, pc.scale, pc.ratio)),
                   "picks": bool(np.array_equal(kres.solution,
                                                pres.solution)),
                   "value": bool(np.isclose(kres.value, pres.value,
                                            rtol=RTOL_E2E, atol=0.0))},
               "value": [kres.value, pres.value],
               "radius": [kc.radius, pc.radius],
               "scale": [kc.scale, pc.scale],
               "ratio": [kc.ratio, pc.ratio]}
        emit(row)
        bad = [k for k, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and np.isfinite(kres.value)):
            fail(f"{name}: the solution is not k finite rows")
        if any(any(lc.values()) for *_, lc in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches and kl["pairwise"] <= 0:
            fail(f"{name}: pairwise never launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        median_s[name] = statistics.median(ks)
    return launches, median_s


# --------------------------------------------------------------------------
# phase 5: the constrained path
# --------------------------------------------------------------------------

def genre_labels(n: int, m: int, seed: int, device):
    """Synthetic "genre" labels: m groups with Zipf(1) shares (the smallest
    of 16 holds ~1.8 % of the rows).  The follow-up paper
    (arXiv:2002.03175) runs musiXmatch under a genre partition matroid;
    its label file is not in the repo, so the labels are made here."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed + 3)
    w = 1.0 / torch.arange(1, m + 1, dtype=torch.float64, device=device)
    return torch.multinomial((w / w.sum()).float(), n, replacement=True,
                             generator=g).to(torch.int32)


def constrained_calls(full: bool):
    """(name, problem, knobs) of the constrained batch calls; ``full=False``
    is the rehearsal's tiny size."""
    k = 32 if full else GROUPS
    quotas = [k // GROUPS] * GROUPS
    return [
        ("e_cosine_labels_k32", dict(k=k, metric="cosine"), {}),
        ("e_euclidean_labels_k32", dict(k=k), {}),
        ("f_cosine_labels_k32_kp64_b1", dict(k=k, metric="cosine"),
         dict(kprime=64 if full else 16, b=1)),
        ("g_cosine_clique_quotas_k32_kp8",
         dict(k=k, metric="cosine", measure="remote-clique", quotas=quotas),
         dict(kprime=8 if full else 4)),
    ]


def _run_constrained(x, labels, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(x, labels=labels,
                                execution=repro_torch.ExecutionSpec(
                                    use_pallas=use_pallas, device=device,
                                    trace=True, **knobs), **problem)
    idx = res.indices
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, idx, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _agree_constrained(kres, pres, kidx, pidx, labels_np):
    """Kernel against plain on one constrained call: the same picks and
    labels, quotas met, value to rtol 1e-4, per-group radius and
    certificate to rtol 1e-4, the same executed schedule, equal
    counters."""
    import numpy as np
    from repro_torch.device import to_numpy
    mat = kres.plan.matroid
    kc, pc = kres.cert, pres.cert

    def close(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return a.shape == b.shape and bool(np.allclose(a, b, rtol=RTOL_E2E,
                                                       atol=0.0))
    agree = {
        "picks": bool(np.array_equal(kidx, pidx)),
        "labels": bool(np.array_equal(kres.labels, pres.labels)
                       and np.array_equal(labels_np[kidx], kres.labels)),
        "quotas": bool(mat.basis_feasible(np.bincount(kres.labels,
                                                      minlength=mat.m))),
        "value": bool(np.isclose(kres.value, pres.value, rtol=RTOL_E2E,
                                 atol=0.0)),
        "counters": dict(kres.telemetry.counters)
        == dict(pres.telemetry.counters),
    }
    if kres.coreset is not None:
        agree["group_radius"] = close(to_numpy(kres.coreset.radius),
                                      to_numpy(pres.coreset.radius))
    if kc is not None or pc is not None:
        agree["certificate"] = (
            kc.meets_target == pc.meets_target
            and close((kc.radius, kc.scale, kc.ratio),
                      (pc.radius, pc.scale, pc.ratio))
            and close(kc.group_ratios, pc.group_ratios))
        agree["b_schedule"] = kc.b_schedule == pc.b_schedule
    return agree


def phase_constrained(x, labels, device, check_launches: bool,
                      runs: int = 3, full: bool = True):
    """The constrained batch calls, ``runs`` per side in turns, then the
    constrained stream.  Returns (launches of the first kernel run of each
    call, summed; per-call kernel median seconds)."""
    import numpy as np
    from repro_torch.device import to_numpy
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    labels_np = to_numpy(labels)
    sizes = np.bincount(labels_np, minlength=GROUPS)
    emit({"phase": "constrained", "labels": "synthetic genres, Zipf(1)",
          "groups": GROUPS, "group_rows": sizes.tolist()})
    order = (["auto", False, False, "auto"] * runs)[:2 * runs]
    for name, problem, knobs in constrained_calls(full):
        out = {"auto": [], False: []}
        for use_pallas in order:
            out[use_pallas].append(_run_constrained(x, labels, problem, knobs,
                                                    use_pallas, device))
        (kres, kidx, _, kl), (pres, pidx, _, _) = out["auto"][0], \
            out[False][0]
        for side in ("auto", False):
            first, idx0 = out[side][0][0], out[side][0][1]
            for res, idx, _, _ in out[side][1:]:
                if not (np.array_equal(idx, idx0)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        ks = [r[2] for r in out["auto"]]
        ps = [r[2] for r in out[False]]
        kc = kres.cert
        row = {"phase": "constrained", "call": name, "n": int(x.shape[0]),
               "d": int(x.shape[1]),
               "problem": {k: v for k, v in problem.items()
                           if k != "quotas"},
               "quotas": f"{problem['quotas'][0]} per group"
               if "quotas" in problem else "labels alone (balanced)",
               "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_over_plain_median":
                   statistics.median(ks) / statistics.median(ps),
               "kernel_launches": kl,
               "coreset_rows": kres.telemetry.extras["coreset_size"],
               "counters": dict(kres.telemetry.counters),
               "value": [kres.value, pres.value],
               "agree": _agree_constrained(kres, pres, kidx, pidx,
                                           labels_np)}
        if kres.coreset is not None:
            row["group_radius"] = [to_numpy(kres.coreset.radius).tolist(),
                                   to_numpy(pres.coreset.radius).tolist()]
        if kc is not None:
            row.update({"ratio": [kc.ratio, pres.cert.ratio],
                        "meets_target": kc.meets_target,
                        "kprime": kc.kprime,
                        "b_schedule": list(map(list, kc.b_schedule)),
                        "worst_group_ratio": max(kc.group_ratios)})
        emit(row)
        bad = [k for k, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and len(set(kidx.tolist())) == problem["k"]):
            fail(f"{name}: solution is not k distinct finite rows")
        if any(any(lc.values()) for *_, lc in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches:
            want = ["gmm_grouped_topb"] + (
                ["pairwise"] if problem.get("measure") == "remote-clique"
                else [])
            if any(kl[w] <= 0 for w in want):
                fail(f"{name}: {want} not all launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        median_s[name] = statistics.median(ks)
    s_launches, s_median = phase_constrained_stream(
        x, labels, device, check_launches, runs=runs, full=full)
    for k, v in s_launches.items():
        launches[k] += v
    median_s.update(s_median)
    return launches, median_s


def phase_constrained_stream(x, labels, device, check_launches: bool,
                             runs: int = 3, full: bool = True):
    """Call (h): the constrained stream over the whole data, ``runs`` calls
    per side in turns; kernel and plain must agree."""
    import numpy as np
    import torch
    from repro_torch.device import to_numpy
    k = 32 if full else GROUPS
    chunk = 4096 if full else 512
    problem = dict(k=k, metric="cosine", quotas=[k // GROUPS] * GROUPS)
    knobs = dict(mode="streaming", kprime=256 if full else 16, chunk=chunk)
    name = "h_cosine_stream_quotas_k32_kp256"
    n = int(x.shape[0])
    chunks = -(-n // chunk)
    out = {"auto": [], False: []}
    for use_pallas in (["auto", False, False, "auto"] * runs)[:2 * runs]:
        out[use_pallas].append(_run_constrained(x, labels, problem, knobs,
                                                use_pallas, device))
    for side in ("auto", False):
        res0, idx0 = out[side][0][0], out[side][0][1]
        for res, idx, _, _ in out[side][1:]:
            if not (np.array_equal(idx, idx0) and res.value == res0.value):
                fail(f"{name}: a repeated run gave another answer")
    kres, kidx, _, kl = out["auto"][0]
    pres, pidx, _, _ = out[False][0]
    ks = [r[2] for r in out["auto"]]
    ps = [r[2] for r in out[False]]
    tr = kres.telemetry
    row = {"phase": "constrained", "call": name, "n": n,
           "d": int(x.shape[1]), "problem": {"k": k, "metric": "cosine"},
           "quotas": f"{k // GROUPS} per group", "knobs": knobs,
           "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
           "kernel_points_per_s": n / statistics.median(ks),
           "plain_points_per_s": n / statistics.median(ps),
           "chunks": chunks, "tiles": tr.counters["device_dispatches"],
           "merges": tr.counters.get("merges", 0),
           "far_inserts": tr.counters.get("far_inserts", 0),
           "host_reads_per_chunk": tr.counters["host_syncs"] / chunks,
           "coreset_rows": tr.extras["coreset_size"],
           "kernel_launches": kl, "value": kres.value,
           "ratio": kres.cert.ratio,
           "worst_group_ratio": max(kres.cert.group_ratios),
           "agree": _agree_constrained(kres, pres, kidx, pidx,
                                       to_numpy(labels))}
    emit(row)
    bad = [key for key, ok in row["agree"].items() if not ok]
    if bad:
        fail(f"{name}: kernel and plain disagree on {bad}")
    if not (np.isfinite(kres.solution).all()
            and kres.solution.shape == (k, x.shape[1])
            and len(set(kidx.tolist())) == k):
        fail(f"{name}: solution is not k distinct finite rows")
    if any(any(lc.values()) for *_, lc in out[False]):
        fail(f"{name}: a kernel launched on a plain run")
    if check_launches and kl["pairwise"] <= 0:
        fail(f"{name}: pairwise never launched on the kernel run")
    if x.is_cuda:
        torch.cuda.empty_cache()
    return kl, {name: statistics.median(ks)}


# --------------------------------------------------------------------------
# phase 6: times
# --------------------------------------------------------------------------

def _time_ms(fn, reps: int = 10):
    """(device ms per call, host ms per call): the median of three
    CUDA-event windows of ``reps`` calls, and the host time to enqueue them
    (a call whose host time nears its device time is host-bound)."""
    import torch
    fn()
    fn()
    ts, hs = [], []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        hs.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts), statistics.median(hs)


def bound_ms(n, d, b, p):
    """Least time for one cosine sweep: the larger of the bytes the function
    must move (points and centers read once, min_in and mask read, min_out
    written, the p (value, index) pairs written) over the memory rate and
    its fp32 flops over the CUDA-core rate."""
    bytes_ = n * d * 4 + 9 * n + b * d * 4 + p * 8
    flops = 2 * n * d * b
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_times(x, seed: int):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_topb import launch_sweep, tile_rows
    n, d = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed + 2)
    prep = ops.prepare(x, "cosine")
    mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    min_in = torch.full((n,), float("inf"), device=x.device)
    rows = []
    for b in (1, 8):
        cen = prep.points[torch.randint(0, n, (b,), generator=gen,
                                        device=x.device)]
        for p in (1, 128):
            bn = tile_rows(p)
            bms, bby = bound_ms(n, d, b, p)
            kern = (lambda: ops.gmm_update_select(
                prep.points, cen, min_in, mask, "cosine", prepared=True)) \
                if p == 1 else (lambda: ops.gmm_topb(
                    prep.points, cen, min_in, mask, "cosine", p=p,
                    prepared=True))
            plain = (lambda: ref.gmm_update_select_ref(
                prep.points, cen, min_in, mask, "cosine")) if p == 1 else \
                (lambda: ref.gmm_topb_ref(prep.points, cen, min_in, mask,
                                          "cosine", p))
            sweep_only = (lambda: launch_sweep(
                prep.points, cen, None, min_in, mask, mode="cosine", p=p,
                bn=bn))
            ms, host_ms = _time_ms(kern)
            kms, _ = _time_ms(sweep_only)
            pms, plain_host_ms = _time_ms(plain)
            rows.append({"kernel": "gmm_update_select" if p == 1
                         else "gmm_topb", "mode": "cosine", "n": n, "d": d,
                         "b": b, "p": p, "bn": bn, "ms": ms,
                         "host_ms": host_ms, "launch_only_ms": kms,
                         "plain_ms": pms, "plain_host_ms": plain_host_ms,
                         "bound_ms": bms, "bound_by": bby,
                         "GBps": (n * d * 4 + 9 * n) / (ms * 1e-3) / 1e9})
    emit({"phase": "times", "rows": rows})
    return rows


def grouped_bound_ms(n, d, m, bc, p):
    """Least time for one grouped sweep: the larger of its bytes (points and
    centers read once, min_in and labels read, min_out written, the m·p
    (value, index) pairs written) over the memory rate and its own-group
    operations (2·n·bc·d, float64 on the FP64 tensor cores) over their
    rate."""
    bytes_ = n * d * 4 + 12 * n + m * bc * d * 4 + m * p * 8
    tb = bytes_ / HBM_BYTES_PER_S * 1e3
    to = 2 * n * bc * d / FP64_TC_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_times_grouped(x, labels, seed: int):
    """B4 at the main shape: 16 groups of 8 centers at p = 128 (the block
    step's pool at b = 8) and p = 1, 16 groups of one center at p = 1 (the
    sweep of call (f)), and 64 groups of 8 at p = 128.  No single PyTorch
    call fuses the own-group distance, the min and a per-group top-p, so
    there is no library time."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_update import grouped_tile_rows
    n, d = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed + 4)
    prep = ops.prepare(x, "cosine")
    min_in = torch.full((n,), float("inf"), device=x.device)
    rows = []
    for m, p, bc in ((GROUPS, 128, 8), (GROUPS, 1, 8), (GROUPS, 1, 1),
                     (64, 128, 8)):
        lab = labels if m == GROUPS else torch.randint(
            0, m, (n,), generator=gen, device=x.device, dtype=torch.int32)
        cen = prep.points[torch.randint(0, n, (m * bc,), generator=gen,
                                        device=x.device)].view(m, bc, d)
        kern = (lambda: ops.grouped_gmm_topb(prep.points, cen, min_in, lab,
                                             "cosine", p, prepared=True))
        plain = (lambda: ref.gmm_grouped_topb_ref(prep.points, cen, min_in,
                                                  lab, "cosine", p))
        ms, host_ms = _time_ms(kern)
        pms, _ = _time_ms(plain)
        bms, bby = grouped_bound_ms(n, d, m, bc, p)
        rows.append({"kernel": "gmm_grouped_topb", "mode": "cosine", "n": n,
                     "d": d, "m": m, "bc": bc, "p": p,
                     "bn": grouped_tile_rows(p), "ms": ms,
                     "host_ms": host_ms, "plain_ms": pms,
                     "library_ms": None, "bound_ms": bms, "bound_by": bby,
                     "share_of_bound": bms / ms,
                     "GBps": (n * d * 4 + 12 * n) / (ms * 1e-3) / 1e9})
    emit({"phase": "times", "rows": rows})
    return rows


def pairwise_bound_ms(m, n, d):
    """Least time for one distance tile: its operations (2·m·n·d, run in
    float64 on the FP64 tensor cores) over their rate, 67 TFLOP/s (the
    same figure as fp32 outside the tensor cores), or its bytes (both
    inputs read once, the output written once) over the memory rate,
    whichever is larger."""
    to = 2 * m * n * d / FP64_TC_FLOPS * 1e3
    tb = ((m + n) * d + m * n) * 4 / HBM_BYTES_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_times_pairwise(tiles):
    """B3 at the streaming tile shapes: the wrapper the stream calls
    (kernel), its plain version, and for euclidean the one PyTorch call
    that computes the same function, ``torch.cdist`` with the matrix-product
    form (the library time; the port never calls it here)."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = []
    for label, x, y, mode in tiles:
        px, py = ops.prepare(x, mode), ops.prepare(y, mode)
        m, d = px.points.shape
        n = py.points.shape[0]
        kern = (lambda: ops.pairwise(px.points, py.points, mode, xsq=px.xsq,
                                     ysq=py.xsq, prepared=True))
        plain = (lambda: ref.pairwise_ref(px.points, py.points, mode,
                                          xsq=px.xsq, ysq=py.xsq))
        ms, host_ms = _time_ms(kern)
        pms, _ = _time_ms(plain, reps=3)
        lib = None
        if mode == "euclidean":
            lib, _ = _time_ms(lambda: torch.cdist(
                px.points, py.points,
                compute_mode="use_mm_for_euclid_dist"))
        bms, bby = pairwise_bound_ms(m, n, d)
        rows.append({"kernel": "pairwise", "tile": label, "mode": mode,
                     "m": m, "n": n, "d": d, "ms": ms, "host_ms": host_ms,
                     "plain_ms": pms, "library_ms": lib, "bound_ms": bms,
                     "bound_by": bby, "share_of_bound": bms / ms,
                     "gflops": 2 * m * n * d / (ms * 1e-3) / 1e9})
    emit({"phase": "times", "rows": rows})
    return rows


# --------------------------------------------------------------------------
# phase 7: where the time of one main-path call goes
# --------------------------------------------------------------------------

def phase_profile(call, name: str, out: Path, unprofiled_s: float):
    """Device-only torch.profiler trace (CUPTI kernel activity, no host-op
    recording) over one main-path call with the kernels (``call()``):
    device time by kernel name, and the device's busy share of that same
    call's wall time — the union of the device activity intervals over the
    host time from entry to the final synchronize.  The second of two
    traced calls is kept (the first pays CUPTI set-up).  ``unprofiled_s``
    (the call's median from its phase) is printed beside it to show what
    the trace itself costs the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:                   # union of the device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kernels = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append({"name": e.key[:90], "ms": us / 1e3,
                        "count": e.count})
    kernels.sort(key=lambda r: -r["ms"])
    (out / f"profile_{name}.json").write_text(json.dumps(
        {"wall_s": wall, "device_busy_s": busy_us / 1e6,
         "kernels": kernels}, indent=1))
    emit({"phase": "profile", "call": name,
          "profiled_wall_s": wall, "unprofiled_median_s": unprofiled_s,
          "device_busy_s": busy_us / 1e6 if spans else "not measured",
          "device_busy_share": busy_us / 1e6 / wall if spans
          else "not measured",
          "top": kernels[:8]})


# --------------------------------------------------------------------------

def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of phases 2-4 with the plain versions")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the CUDA port on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    if args.rehearse:
        data = {"mxm": musixmatch_like(3000, 64, args.seed, "cpu"),
                "sphere": unit_sphere(20000, args.seed, "cpu")}
        phase_kernels(data["mxm"], args.seed, small_only=True,
                      tiles=stream_tiles(data["mxm"], data["sphere"],
                                         REHEARSAL_TILES))
        phase_main(data["mxm"], "cpu", check_launches=False, pairs=2)
        phase_stream(data, "cpu", check_launches=False, runs=1, full=False)
        phase_constrained(data["mxm"], genre_labels(3000, GROUPS, args.seed,
                                                    "cpu"),
                          "cpu", check_launches=False, runs=1, full=False)
        emit({"phase": "rehearsal", "ok": True})
        return 0

    # ---- 1. env + build ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    build.library()
    out = ROOT / "chiprun_out"      # long reports: ptxas, profile
    out.mkdir(parents=True, exist_ok=True)
    (out / "nvcc_build.log").write_text(build.BUILD_INFO["log"])
    emit({"phase": "env", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "build_seconds": build.BUILD_INFO["seconds"],
          "build_cached": build.BUILD_INFO["cached"]})

    # ---- data -------------------------------------------------------------
    t0 = time.perf_counter()
    x = musixmatch_like(237662, 5000, args.seed, "cuda")
    sphere = unit_sphere(2 ** 24, args.seed, "cuda")
    torch.cuda.synchronize()
    nnz = (x > 0).sum(dim=1).float()
    emit({"phase": "data", "shape": list(x.shape), "seed": args.seed,
          "gb": x.numel() * 4 / 1e9,
          "words_per_row": [float(nnz.min()), float(nnz.mean()),
                            float(nnz.max())],
          "sphere_shape": list(sphere.shape),
          "sphere_gb": sphere.numel() * 4 / 1e9,
          "seconds": time.perf_counter() - t0})
    tiles = stream_tiles(x, sphere, STREAM_TILES)

    # ---- 2. kernels vs plain ---------------------------------------------
    errs, _ = phase_kernels(x, args.seed, small_only=False, tiles=tiles,
                            out=out)
    torch.cuda.empty_cache()

    # ---- 3. batch path, 4. streaming path -------------------------------
    launches, main_s = phase_main(x, "cuda", check_launches=True)
    torch.cuda.empty_cache()
    s_launches, stream_s = phase_stream({"mxm": x, "sphere": sphere},
                                        "cuda", check_launches=True)
    for k, v in s_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 5. constrained path --------------------------------------------
    genres = genre_labels(x.shape[0], GROUPS, args.seed, "cuda")
    c_launches, constrained_s = phase_constrained(x, genres, "cuda",
                                                  check_launches=True)
    for k, v in c_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 6. times, 7. profile ---------------------------------------------
    rows = phase_times(x, args.seed)
    g_rows = phase_times_grouped(x, genres, args.seed)
    far = x.shape[0] // 2
    b_rows = phase_times_pairwise(tiles + [(
        "stream tile 4096x1025x5000 euclidean", x[:4096],
        x[far:far + 1025], "euclidean")])
    import repro_torch
    phase_profile(lambda: repro_torch.diversify(
        x, k=16, metric="cosine",
        execution=repro_torch.ExecutionSpec(device="cuda")).indices,
        "batch_a_cosine_defaults", out, main_s["a_cosine_defaults"])
    _, kind, problem, knobs = stream_calls(True)[1]
    phase_profile(lambda: repro_torch.diversify(
        x, execution=repro_torch.ExecutionSpec(
            mode="streaming", device="cuda", **knobs), **problem),
        "stream_b_cosine_edge_k128_kp1024", out,
        stream_s["b_cosine_edge_k128_kp1024"])
    _, problem, knobs = constrained_calls(True)[0]
    phase_profile(lambda: repro_torch.diversify(
        x, labels=genres, execution=repro_torch.ExecutionSpec(
            device="cuda", **knobs), **problem).indices,
        "constrained_e_cosine_labels_k32", out,
        constrained_s["e_cosine_labels_k32"])
    pick = {"gmm_topb": next(r for r in rows if r["b"] == 8 and r["p"] == 128),
            "gmm_update_select": next(r for r in rows if r["b"] == 1
                                      and r["p"] == 1),
            # the tile where B3 meets a library call: (b)'s size, euclidean
            "pairwise": next(r for r in b_rows if r["d"] == x.shape[1]
                             and r["mode"] == "euclidean"),
            "gmm_grouped_topb": next(r for r in g_rows
                                     if r["m"] == GROUPS and r["p"] == 128
                                     and r["bc"] == 8)}
    at_keys = {"gmm_topb": ("mode", "n", "d", "b", "p"),
               "gmm_update_select": ("mode", "n", "d", "b", "p"),
               "pairwise": ("mode", "m", "n", "d"),
               "gmm_grouped_topb": ("mode", "n", "d", "m", "bc", "p")}
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port pulled in jax or the reference package")
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "script_seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": pick[name]["ms"],
         "plain_ms": pick[name]["plain_ms"],
         "bound_ms": pick[name]["bound_ms"],
         "bound_by": pick[name]["bound_by"],
         # B1/B2/B4: no single PyTorch call fuses distance, min and top-p
         "library_ms": pick[name].get("library_ms"),
         "at": {k: pick[name][k] for k in at_keys[name]}}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
