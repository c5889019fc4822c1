"""One front door: ``repro_torch.diversify(ProblemSpec, ExecutionSpec)``
(port of ``repro.api``, batch and streaming slices).

* ``ProblemSpec`` says WHAT to solve (points, ``k``, measure, metric);
* ``ExecutionSpec`` says HOW: the reference's fields (so one kwargs dict
  builds both specs) plus ``device`` (default ``"cuda"``; the points move
  there once and stay);
* ``plan()`` compiles the two into an inspectable ``Plan`` whose
  ``explain()`` prints the same text as the reference's for a batch plan;
* ``Plan.execute()`` / ``diversify()`` runs it and returns a
  ``DiversityResult`` — ``solution``, ``value``, ``indices``, the
  ``RadiusCertificate`` and per-phase telemetry.

``use_pallas="auto"`` resolves to the hand-written CUDA kernels on a CUDA
device (plain torch on the CPU, and for ``manhattan``, which has no kernel
mode); ``True`` on the CPU raises.  Batch and streaming modes are ported:
a chunk iterator, ``mode="streaming"`` or an array over
``memory_budget_bytes`` runs the one-pass SMM core-set
(``core.smm.StreamingCoreset``), whose distance tiles go through the B3
kernel.  MapReduce, serving, dynamic and constrained problems, and
``resilience=`` on a stream, raise ``NotImplementedError`` from ``plan()``
naming the ROADMAP slice that brings them.

>>> import numpy as np
>>> import repro_torch
>>> pts = np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32)
>>> res = repro_torch.diversify(pts, k=4, execution=repro_torch.ExecutionSpec(
...     mode="batch", kprime=16, b=1, device="cpu"))
>>> res.solution.shape
(4, 4)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .device import as_points, resolve_device, resolve_use_pallas, to_numpy

_MODES = ("auto", "batch", "streaming", "mapreduce", "serving", "dynamic")

# modes and problem kinds of the reference that later slices bring
_NOT_PORTED = {
    "mapreduce": "mapreduce mode (ROADMAP A, slice 10: core/distributed.py)",
    "constrained": "constrained selection (ROADMAP A, slice 11: "
                   "repro.constrained)",
    "serving": "serving mode (ROADMAP A, slice 13: serving/rerank.py)",
    "dynamic": "dynamic mode (ROADMAP A, slice 14: repro.dynamic)",
    "resilience": "resilience= on a stream (ROADMAP A, slice 12: "
                  "ResiliencePolicy, CheckpointManager)",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{_NOT_PORTED[what]} is not ported to repro_torch yet; use the "
        "reference package repro for it")


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ProblemSpec:
    """WHAT to solve: an in-memory ``(n, d)`` array or tensor ``points``, or
    an iterable of ``(c, d)`` chunks (a stream; ``dim`` optionally names d
    up front), the budget ``k``, the measure and the metric.  ``weights``
    are optional integer multiplicities for a pre-weighted (generalized)
    batch input.  ``labels``/``matroid``/``quotas`` keep the reference's
    fields; the constrained problems they describe are not ported."""
    points: Any
    k: int
    measure: str = "remote-edge"
    metric: str = "euclidean"
    weights: Any = None
    labels: Any = None
    matroid: Any = None
    quotas: Any = None
    dim: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionSpec:
    """HOW to solve it.  Every field of the reference's ``ExecutionSpec``
    with its default, plus ``device``: where the points live and the
    engine runs (``"cuda"`` by default; ``"cpu"`` runs the plain torch
    path).  A CUDA device that is not present raises."""
    mode: str = "auto"
    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)
    num_reducers: Optional[int] = None
    memory_budget_bytes: Optional[int] = None
    kprime: Any = "auto"
    b: Any = "auto"
    eps: Optional[float] = None
    chunk: Any = "auto"
    schedule: Any = None
    use_pallas: Any = "auto"
    generalized: bool = False
    three_round: bool = False
    recursive: bool = False
    partition: str = "contiguous"
    seed: int = 0
    swap_rounds: int = 10
    smm_mode: Optional[str] = None
    rebuild: Any = "auto"
    tau: Optional[float] = None
    cliff: Optional[float] = None
    sprint: Any = "auto"
    resilience: Any = None
    trace: Any = "auto"
    device: str = "cuda"


@dataclasses.dataclass(frozen=True, eq=False)
class DiversityResult:
    """Uniform outcome of a run.

    ``solution`` is the ``(k, d)`` selected points (host numpy) and
    ``value`` the diversity objective on them.  ``indices`` are distinct
    input-row ids (None for generalized instantiation and weighted input),
    ``cert`` the ``RadiusCertificate`` measured by the engine (None when
    every knob was pinned), ``coreset`` the core-set container (tensors on
    the run's device) and ``telemetry`` the run's ``RunTrace``.
    """
    solution: np.ndarray
    value: float
    _indices: Any               # ndarray | thunk | None (see ``indices``)
    labels: Optional[np.ndarray]
    cert: Any
    coreset: Any
    telemetry: Any
    plan: "Plan"

    @property
    def indices(self) -> Optional[np.ndarray]:
        """Distinct input-row ids of the solution, or None (computed on
        first access, then cached)."""
        ind = self._indices
        if callable(ind):
            ind = ind()
            object.__setattr__(self, "_indices", ind)
        return ind


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------

def _is_array(points) -> bool:
    return hasattr(points, "shape") and hasattr(points, "dtype")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{int(n)} B" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} GiB"                            # pragma: no cover


def _itemsize(points) -> int:
    dt = points.dtype
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return int(np.dtype(dt).itemsize)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A compiled (ProblemSpec, ExecutionSpec) pair: resolved mode, knobs and
    layout, inspectable via ``explain()``, runnable via ``execute()``."""
    problem: ProblemSpec
    execution: ExecutionSpec
    mode: str
    reason: str
    constrained: bool
    matroid: Any
    variant: str                 # plain | ext | gen
    mesh: Any
    num_reducers: Optional[int]
    knobs: dict                  # resolved engine knobs (+ "device")
    layout: str
    kprime_plan: str
    coreset_rows: Optional[int]
    coreset_bytes: Optional[int]
    n: Optional[int]
    d: Optional[int]
    requests: Optional[int] = None
    updates: Optional[int] = None

    @property
    def trace(self):
        """The ``RunTrace`` of the last ``execute()`` of this plan."""
        return getattr(self, "_trace", None)

    def explain(self, actual: bool = False) -> str:
        """Stable human-readable rendering — the reference's text for the
        same batch or streaming specs.  ``actual=True`` appends predicted vs
        measured rows read from the last ``execute()``."""
        from .core.sequential import SEQ_ALPHA

        k = self.knobs
        shape = (f"({self.n}, {self.d})" if self.n is not None
                 else f"stream (d={self.d if self.d is not None else '?'})")
        rows = ("?" if self.coreset_rows is None else
                f"{'<=' if k['kprime'] == 'auto' else ''}{self.coreset_rows}")
        bts = ("?" if self.coreset_bytes is None else
               f"{'<=' if k['kprime'] == 'auto' else ''}"
               f"{_fmt_bytes(self.coreset_bytes)}")
        lines = [
            "DiversityPlan",
            f"  mode: {self.mode} ({self.reason})",
            f"  problem: k={self.problem.k}, measure={self.problem.measure},"
            f" metric={self.problem.metric}, input={shape},"
            " constrained=no",
            f"  coreset: {self.variant} construction, {self.kprime_plan}",
            f"  engine: b={k['b']}, chunk={k['chunk']},"
            f" schedule={'none' if k['schedule'] is None else k['schedule']},"
            f" use_pallas={k['use_pallas']},"
            f" tau={k['tau']}, cliff={k['cliff']}"
            + (f", sprint={k['sprint']}"
               if k['b'] == "auto" or k['kprime'] == "auto" else ""),
            f"  layout: {self.layout}",
            f"  predicted coreset: {rows} rows, {bts}",
            f"  solver: sequential alpha={SEQ_ALPHA[self.problem.measure]}"
            f" ({self.problem.measure})",
        ]
        if actual:
            lines.extend(self._explain_actual())
        return "\n".join(lines)

    def _explain_actual(self):
        tr = self.trace
        if tr is None:
            return ["  measured: (no trace — run plan.execute() first)"]
        ph = " ".join(f"{p['name']}={p['seconds']:.4f}s" for p in tr.phases)
        lines = [f"  measured: {ph} (total {tr.total_seconds():.4f}s)"]
        rows = tr.extras.get("coreset_size")
        if rows is not None and self.coreset_rows:
            err_r = rows / self.coreset_rows
            line = (f"  measured coreset: {rows} rows"
                    f" (predicted {self.coreset_rows}, x{err_r:.2f})")
            if self.coreset_bytes and self.d is not None:
                bts = rows * self.d * 4 + (rows * 4 if self.variant == "gen"
                                           else 0)
                line += (f", {_fmt_bytes(bts)} (predicted"
                         f" {_fmt_bytes(self.coreset_bytes)},"
                         f" x{bts / self.coreset_bytes:.2f})")
            lines.append(line)
        if tr.counters:
            cs = " ".join(f"{k}={tr.counters[k]:,}"
                          for k in sorted(tr.counters))
            lines.append(f"  counters: {cs}")
        return lines

    def execute(self) -> DiversityResult:
        return _execute(self)


def plan(problem: ProblemSpec, execution: Optional[ExecutionSpec] = None
         ) -> Plan:
    """Compile (ProblemSpec, ExecutionSpec) into an inspectable ``Plan``.

    Pure resolution — nothing executes.  Raises ``NotImplementedError`` for
    the modes and problem kinds this port does not cover yet, and
    ``RuntimeError`` when ``device`` names a CUDA device that is absent.
    """
    from .core.adaptive import auto_milestones, resolve_bars
    from .core.measures import MEASURES, NEEDS_INJECTIVE
    from .core.metrics import get_metric

    ex = execution or ExecutionSpec()
    if problem.measure not in MEASURES:
        raise ValueError(f"unknown measure {problem.measure!r}; "
                         f"one of {sorted(MEASURES)}")
    metric = get_metric(problem.metric)
    if problem.k < 1:
        raise ValueError(f"k must be >= 1, got {problem.k}")
    if ex.mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {ex.mode!r}")
    device = resolve_device(ex.device)

    arr = _is_array(problem.points)
    if arr and problem.points.ndim == 3:
        raise _not_ported("serving")
    if (problem.labels is not None or problem.matroid is not None
            or problem.quotas is not None):
        raise _not_ported("constrained")
    n = int(problem.points.shape[0]) if arr else None
    d = (int(problem.points.shape[1]) if arr and problem.points.ndim > 1
         else problem.dim)

    # ---- mode ------------------------------------------------------------
    if ex.mode != "auto":
        if ex.mode not in ("batch", "streaming"):
            raise _not_ported(ex.mode)
        mode, reason = ex.mode, "requested"
    elif not arr:
        mode, reason = "streaming", "auto: chunk-iterator input"
    elif ex.mesh is not None or (ex.num_reducers or 0) > 1:
        raise _not_ported("mapreduce")
    elif (ex.memory_budget_bytes is not None
          and n * (d or 1) * _itemsize(problem.points)
          > ex.memory_budget_bytes):
        mode, reason = "streaming", (
            f"auto: input {n * (d or 1) * _itemsize(problem.points)} B "
            f"exceeds memory budget {ex.memory_budget_bytes} B")
    else:
        mode, reason = "batch", "auto: in-memory array"
    if not arr and mode != "streaming":
        raise ValueError(f"a chunk-iterator source only supports "
                         f"mode='streaming', got {mode!r}")
    if ex.rebuild not in ("auto", None):
        raise ValueError(f"rebuild= tunes the dynamic index and has no "
                         f"{mode} path")
    if ex.three_round:
        raise ValueError("three_round=True needs the mapreduce mesh path "
                         "(use generalized=True for the simulated path)")
    if ex.recursive:
        raise ValueError("recursive=True needs the unconstrained mapreduce "
                         "mesh path")
    if problem.weights is not None and mode != "batch":
        raise ValueError("weights= is batch-only (generalized input)")
    if problem.weights is not None \
            and len(np.atleast_1d(np.asarray(problem.weights))) != n:
        raise ValueError(
            f"weights= must have one entry per point: got "
            f"{len(np.atleast_1d(np.asarray(problem.weights)))} for n={n}")
    if ex.smm_mode is not None and ex.smm_mode not in ("plain", "ext",
                                                       "gen"):
        raise ValueError(f"smm_mode must be one of 'plain'/'ext'/'gen', "
                         f"got {ex.smm_mode!r}")
    if ex.resilience is not None:
        if mode == "streaming":
            raise _not_ported("resilience")
        raise ValueError("resilience= applies to streaming and mapreduce "
                         "runs (batch is one local dispatch with nothing to "
                         "retry or degrade to)")
    if mode == "streaming" and not metric.is_metric:
        raise ValueError(f"SMM needs a true metric, got {problem.metric!r}")

    # ---- variant ---------------------------------------------------------
    if mode == "streaming" and ex.smm_mode is not None:
        variant = ex.smm_mode
    elif ex.generalized or ex.smm_mode == "gen":
        variant = "gen"
    else:
        variant = "ext" if problem.measure in NEEDS_INJECTIVE else "plain"

    # ---- knobs -----------------------------------------------------------
    k = problem.k
    kprime = ex.kprime
    if kprime is None or (kprime == "auto" and mode == "streaming"):
        kprime = max(2 * k, 32)           # the SMM state is fixed-size
    if isinstance(kprime, (int, np.integer)) and mode == "batch":
        kprime = min(int(kprime), n)      # the batch engine clamps k' to n
    chunk = ex.chunk
    if chunk == "auto":
        chunk = 4096 if mode == "streaming" else 0
    use_pallas = resolve_use_pallas(ex.use_pallas, device, metric.name)
    eps_eff = 0.1 if ex.eps is None else ex.eps
    tau, cliff = resolve_bars(ex.tau, ex.cliff)
    knobs = {"kprime": kprime, "b": ex.b, "chunk": chunk, "eps": ex.eps,
             "schedule": ex.schedule, "use_pallas": use_pallas,
             "tau": tau, "cliff": cliff, "sprint": ex.sprint,
             "device": device}

    # ---- k' plan + layout + footprint ------------------------------------
    if mode == "streaming":
        layout = f"one pass, chunk={chunk}, state cap 1x({kprime}+1) centers"
    else:
        layout = "single machine, one partition"
    if isinstance(kprime, (int, np.integer)):
        kp_num = int(kprime)
        kprime_plan = f"kprime={kp_num} (fixed)"
    else:
        kmax, miles = auto_milestones(k, n)
        kp_num = kmax
        arrow = " -> ".join(str(c) for c in miles + [kmax])
        kprime_plan = (f"kprime=auto (milestones {arrow}, eps={eps_eff}, "
                       "x2 first step, secant-refined)")
    rows_per = kp_num * (k if variant == "ext" else 1)
    bytes_ = None if d is None else rows_per * d * 4 + (
        rows_per * 4 if variant == "gen" else 0)
    return Plan(problem=problem, execution=ex, mode=mode, reason=reason,
                constrained=False, matroid=None, variant=variant, mesh=None,
                num_reducers=None, knobs=knobs, layout=layout,
                kprime_plan=kprime_plan, coreset_rows=rows_per,
                coreset_bytes=bytes_, n=n, d=d)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _value_of(sol, measure: str, metric: str) -> float:
    """The objective of the solution, its (k, k) distance matrix computed
    where the solution lives."""
    from .core.measures import diversity
    from .core.metrics import get_metric

    sol = torch.as_tensor(sol, dtype=torch.float32)
    return diversity(measure, to_numpy(get_metric(metric).pairwise(sol, sol)))


def _indices_of(plan_: Plan, pts, sol):
    """Thunk recovering distinct input-row indices for the solution (run
    lazily on first ``DiversityResult.indices`` access) from the device
    copy of the points (``pts``; None moves the input array there on first
    access), or None when the path cannot recover rows (a stream, a
    generalized core-set)."""
    if plan_.n is None or plan_.variant == "gen":
        return None

    def match():
        from .data.selection import _match_rows
        rows = pts if pts is not None else as_points(
            plan_.problem.points, plan_.knobs["device"])
        return _match_rows(rows, sol, plan_.problem.k)

    return match


def _chunks_of(problem: ProblemSpec, chunk: int):
    """The points source as an iterator of chunks.  A tensor is sliced
    where it lies (a tensor on the card is never copied to the host); any
    other array is cast per chunk, never as a whole, so the memory-budget
    streaming path holds one chunk at a time."""
    pts = problem.points
    if not _is_array(pts):
        yield from pts
        return
    step = chunk if chunk and chunk > 0 else 4096
    for i in range(0, int(pts.shape[0]), step):
        part = pts[i:i + step]
        yield part if isinstance(part, torch.Tensor) else \
            np.asarray(part, np.float32)


def _run_batch(plan_: Plan, tr) -> DiversityResult:
    from .core.coreset import GeneralizedCoreset, build_coreset
    from .core.sequential import solve, solve_on_coreset

    p, kb = plan_.problem, plan_.knobs
    t = time.perf_counter()
    pts = as_points(p.points, kb["device"])     # the one move to the device
    if p.weights is not None:
        # pre-weighted (generalized) input: solve multiplicity-aware on the
        # points as given — no core-set build
        cs = GeneralizedCoreset(
            points=pts,
            multiplicity=torch.as_tensor(np.asarray(p.weights),
                                         dtype=torch.int32, device=pts.device),
            radius=torch.zeros((), device=pts.device))
        t = tr.phase("coreset", t, sync=cs)
        cpts, mult = cs.compact()
        idx = solve(p.measure, cpts, p.k, weights=mult, metric=p.metric)
        sol = cpts[torch.as_tensor(idx, device=cpts.device)]
        t = tr.phase("solve", t, sync=sol)
        value = _value_of(sol, p.measure, p.metric)
        tr.phase("value", t)
        return DiversityResult(solution=to_numpy(sol), value=value,
                               _indices=None, labels=None, cert=cs.cert,
                               coreset=cs,
                               telemetry=tr.annotate(mode="batch"),
                               plan=plan_)
    cs = build_coreset(pts, p.k, kb["kprime"], p.measure, metric=p.metric,
                       use_pallas=kb["use_pallas"],
                       generalized=plan_.variant == "gen", b=kb["b"],
                       chunk=kb["chunk"], eps=(0.1 if kb["eps"] is None
                                               else kb["eps"]),
                       schedule=kb["schedule"], tau=plan_.execution.tau,
                       cliff=plan_.execution.cliff, sprint=kb["sprint"])
    t = tr.phase("coreset", t, sync=cs)
    sol = solve_on_coreset(cs, p.k, p.measure, metric=p.metric)
    t = tr.phase("solve", t, sync=sol)
    value = _value_of(sol, p.measure, p.metric)
    tr.phase("value", t)
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=_indices_of(plan_, pts, sol), labels=None, cert=cs.cert,
        coreset=cs,
        telemetry=tr.annotate(mode="batch", coreset_size=getattr(
            cs, "size", None)), plan=plan_)


def _run_streaming(plan_: Plan, tr) -> DiversityResult:
    """One pass of the SMM core-set over the chunks, then the sequential
    solver on the core-set (phases stream / finalize / solve / value)."""
    from .core.sequential import solve_on_coreset
    from .core.smm import StreamingCoreset

    p, kb = plan_.problem, plan_.knobs
    smm: Optional[StreamingCoreset] = None
    dim = plan_.d
    t = time.perf_counter()
    n_seen = 0
    for chunk in _chunks_of(p, kb["chunk"]):
        chunk = as_points(chunk, kb["device"])
        if chunk.ndim < 2:
            chunk = chunk.reshape(1, -1)
        if smm is None:
            dim = chunk.shape[1] if dim is None else dim
            smm = StreamingCoreset(p.k, int(kb["kprime"]), dim,
                                   metric=p.metric, mode=plan_.variant,
                                   eps=kb["eps"], device=kb["device"],
                                   use_pallas=kb["use_pallas"])
        smm.update(chunk)
        n_seen += chunk.shape[0]
    if smm is None:
        raise ValueError("empty stream")
    t = tr.phase("stream", t, sync=smm.state)
    cs = smm.finalize()
    t = tr.phase("finalize", t, sync=cs)
    sol = solve_on_coreset(cs, p.k, p.measure, metric=p.metric)
    t = tr.phase("solve", t, sync=sol)
    value = _value_of(sol, p.measure, p.metric)
    tr.phase("value", t)
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=_indices_of(plan_, None, sol), labels=None, cert=cs.cert,
        coreset=cs,
        telemetry=tr.annotate(mode="streaming", n_seen=n_seen,
                              merges=len(smm.phase_log),
                              coreset_size=getattr(cs, "size", None)),
        plan=plan_)


def _execute(plan_: Plan) -> DiversityResult:
    from . import obs

    tr = obs.trace_from_spec(plan_.execution.trace)
    run = _run_streaming if plan_.mode == "streaming" else _run_batch
    if tr.enabled:
        with obs.activate(tr):
            res = run(plan_, tr)
    else:
        res = run(plan_, tr)
    object.__setattr__(plan_, "_trace", tr)
    return res


def diversify(problem, execution: Optional[ExecutionSpec] = None, *,
              k: Optional[int] = None, measure: str = "remote-edge",
              metric: str = "euclidean", labels=None, matroid=None,
              quotas=None, weights=None, dim: Optional[int] = None
              ) -> DiversityResult:
    """The front door: plan + execute in one call.

    ``problem`` is a ``ProblemSpec``, or a raw points source with ``k=``
    (and the other problem fields) passed as keywords.
    """
    kw_used = (k is not None or labels is not None or matroid is not None
               or quotas is not None or weights is not None or dim is not None
               or measure != "remote-edge" or metric != "euclidean")
    if not isinstance(problem, ProblemSpec):
        if k is None:
            raise ValueError("diversify(points, ...) needs k=")
        problem = ProblemSpec(points=problem, k=k, measure=measure,
                              metric=metric, labels=labels, matroid=matroid,
                              quotas=quotas, weights=weights, dim=dim)
    elif kw_used:
        raise ValueError("pass problem fields inside ProblemSpec, or raw "
                         "points with keywords — not both")
    return plan(problem, execution).execute()
