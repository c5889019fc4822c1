#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # the full run, on one CUDA card

Phases, each printing one JSON line:

1. env      — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, TF32 switched off, the kernels built from
              ``src/repro_torch/kernels/csrc`` with nvcc (build seconds).
2. kernels  — every CUDA kernel held against its plain torch version on the
              card: modes {sqeuclidean, euclidean, dot, cosine}, small ragged
              shapes and the main shape, b in {1, 8}, p in {1, 32, 128, 256};
              fields and selected values must match to 3e-5.
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
4. times    — median kernel and plain times at the main shape by CUDA
              events, beside the bytes bound at 3.35 TB/s.
5. profile  — a device-only torch.profiler trace of call (a): device time
              by kernel and the device's busy share of that call's wall
              time (full table in chiprun_out/).

The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero before it.
``--rehearse`` runs phases 2-3 at a tiny size on the CPU with the plain
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
}


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


def phase_kernels(big, seed: int, small_only: bool):
    import torch
    dev = big.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    errs = {"gmm_topb": 0.0, "gmm_update_select": 0.0}
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
    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "tolerance": TOL,
          "max_abs_err": errs,
          "seconds": time.perf_counter() - t0})
    return errs


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
    launches = {"gmm_topb": 0, "gmm_update_select": 0}
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
# phase 4: times at the main shape
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


# --------------------------------------------------------------------------
# phase 5: where the time of one main-path call goes
# --------------------------------------------------------------------------

def phase_profile(x, out: Path, unprofiled_s: float):
    """Device-only torch.profiler trace (CUPTI kernel activity, no host-op
    recording) over one call (a) with the kernels: device time by kernel
    name, and the device's busy share of that same call's wall time — the
    union of the device activity intervals over the host time from entry to
    the final synchronize.  The second of two traced calls is kept (the
    first pays CUPTI set-up).  ``unprofiled_s`` (phase 3's median) is
    printed beside it to show what the trace itself costs the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    ex = repro_torch.ExecutionSpec(device="cuda")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = repro_torch.diversify(x, k=16, metric="cosine",
                                        execution=ex)
            res.indices
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
    (out / "profile_call_a.json").write_text(json.dumps(
        {"wall_s": wall, "device_busy_s": busy_us / 1e6,
         "kernels": kernels}, indent=1))
    emit({"phase": "profile", "call": "a_cosine_defaults",
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
                    help="tiny CPU run of phases 2-3 with the plain versions")
    args = ap.parse_args(argv)

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
        x = musixmatch_like(3000, 64, args.seed, "cpu")
        phase_kernels(x, args.seed, small_only=True)
        phase_main(x, "cpu", check_launches=False, pairs=2)
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
    torch.cuda.synchronize()
    nnz = (x > 0).sum(dim=1).float()
    emit({"phase": "data", "shape": list(x.shape), "seed": args.seed,
          "gb": x.numel() * 4 / 1e9,
          "words_per_row": [float(nnz.min()), float(nnz.mean()),
                            float(nnz.max())],
          "seconds": time.perf_counter() - t0})

    # ---- 2. kernels vs plain ---------------------------------------------
    errs = phase_kernels(x, args.seed, small_only=False)
    torch.cuda.empty_cache()

    # ---- 3. main path ------------------------------------------------------
    launches, main_s = phase_main(x, "cuda", check_launches=True)
    torch.cuda.empty_cache()

    # ---- 4. times, 5. profile ---------------------------------------------
    rows = phase_times(x, args.seed)
    phase_profile(x, out, main_s["a_cosine_defaults"])
    pick = {"gmm_topb": next(r for r in rows if r["b"] == 8 and r["p"] == 128),
            "gmm_update_select": next(r for r in rows if r["b"] == 1
                                      and r["p"] == 1)}
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port pulled in jax or the reference package")
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": pick[name]["ms"],
         "plain_ms": pick[name]["plain_ms"],
         "bound_ms": pick[name]["bound_ms"],
         "bound_by": pick[name]["bound_by"], "library_ms": None,
         "at": {k: pick[name][k] for k in ("mode", "n", "d", "b", "p")}}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
