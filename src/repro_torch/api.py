"""One front door: ``repro_torch.diversify(ProblemSpec, ExecutionSpec)``
(port of ``repro.api``: batch, streaming, constrained, MapReduce, serving
and dynamic modes, with resilience).

* ``ProblemSpec`` says WHAT to solve (points, ``k``, measure, metric);
* ``ExecutionSpec`` says HOW: the reference's fields (so one kwargs dict
  builds both specs) plus ``device`` (default ``"cuda"``; the points move
  there once and stay);
* ``plan()`` compiles the two into an inspectable ``Plan`` whose
  ``explain()`` prints the same text as the reference's;
* ``Plan.execute()`` / ``diversify()`` runs it and returns a
  ``DiversityResult`` — ``solution``, ``value``, ``indices``, the
  ``RadiusCertificate`` and per-phase telemetry.

``use_pallas="auto"`` resolves to the hand-written CUDA kernels on a CUDA
device (plain torch on the CPU, and for ``manhattan``, which has no kernel
mode); ``True`` on the CPU raises.  Batch and streaming modes are ported:
a chunk iterator, ``mode="streaming"`` or an array over
``memory_budget_bytes`` runs the one-pass SMM core-set
(``core.smm.StreamingCoreset``), whose distance tiles go through the B3
kernel.  Constrained problems (``labels=`` with ``quotas=``, a
``matroid=`` or the labels alone) run in both modes through
``repro_torch.constrained``: per-group core-sets on the grouped sweep (B4)
in batch, one SMM state per group in a stream.  ``mode="mapreduce"`` with
``num_reducers=ℓ`` (or ``num_reducers > 1`` under ``mode="auto"``) runs
the simulated ℓ-reducer MapReduce (``core.distributed``,
``constrained.mapreduce``): round 1 of all reducers is one grouped-engine
run whose every fold is one B4 sweep; ``trace="reducers"`` and
``resilience=`` (a ``repro_torch.distributed.ResiliencePolicy``) run it
one reducer at a time, each reducer a span and a unit that can be retried
or dropped.  ``resilience=`` on a stream retries or drops chunks and, with
``checkpoint_dir``, checkpoints the SMM state every ``checkpoint_every``
chunks and resumes from the latest checkpoint.  A 3-D ``(requests,
candidates, d)`` input (or ``mode="serving"``) runs the fused multi-tenant
rerank (``serving.rerank_batched``): every fold of all requests is one B4
sweep.  A list of ``Insert``/``Delete`` ops (or ``mode="dynamic"``, where an
``(n, d)`` array is a one-insert stream) runs the dynamic index
(``dynamic.DynamicIndex``): its cover maintenance is B3 tiles on the card,
its certified query the m = 1 engine.  ``mesh=`` (a
``torch.distributed`` ``DeviceMesh``) or a ``DTensor`` input placed
``Shard(0)`` runs the MapReduce mesh path, called by every rank of the
mesh: one rank a reducer, round 1 on the rank's rows, round 2 one
all-gather (``three_round=`` and ``recursive=`` as in the reference).

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
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .device import (as_points, is_dtensor, resolve_device,
                     resolve_use_pallas, to_numpy)

_MODES = ("auto", "batch", "streaming", "mapreduce", "serving", "dynamic")

def _warn_legacy(name: str) -> None:
    """The one DeprecationWarning every legacy wrapper emits (and the facade
    path never does)."""
    warnings.warn(
        f"{name} is a legacy entry point; prefer "
        "repro_torch.diversify(ProblemSpec, ExecutionSpec) — one front door "
        "to the same engine.", DeprecationWarning, stacklevel=3)


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ProblemSpec:
    """WHAT to solve: an in-memory ``(n, d)`` array or tensor ``points``, or
    an iterable of ``(c, d)`` chunks (a stream; ``dim`` optionally names d
    up front), the budget ``k``, the measure and the metric.  ``weights``
    are optional integer multiplicities for a pre-weighted (generalized)
    batch input.  ``labels`` (an ``(n,)`` int array of group ids; for a
    stream, the source yields ``(chunk, labels)`` pairs) with ``quotas``
    (exact per-group counts) or ``matroid`` (any ``constrained.matroid``
    oracle) makes the problem constrained; labels alone balance k across
    the groups."""
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


def _mesh_axes(execution: "ExecutionSpec"):
    """The reducer axes of a mesh run: ``data_axes``, or ``('pod', 'data')``
    for the recursive scheme."""
    return (("pod", "data") if execution.recursive
            else tuple(execution.data_axes))


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
        same batch, streaming, simulated MapReduce or serving specs,
        constrained or not.  ``actual=True`` appends predicted vs measured
        rows read from the last ``execute()``."""
        from .core.sequential import SEQ_ALPHA

        k = self.knobs
        if self.mode == "serving":
            lines = [
                "DiversityPlan",
                f"  mode: serving ({self.reason})",
                f"  problem: k={self.problem.k},"
                f" measure={self.problem.measure},"
                f" metric={self.problem.metric},"
                f" input=({self.requests}, {self.n}, {self.d}),"
                " constrained=no",
                f"  rerank: fused multi-tenant vmap of the m=1 engine,"
                f" {self.requests} requests per dispatch",
                f"  engine: b=1 (exact per-request GMM slate),"
                f" chunk={k['chunk']}, use_pallas={k['use_pallas']}",
                f"  layout: {self.layout}",
                f"  predicted slate: {self.requests} x {self.problem.k}"
                f" rows, {_fmt_bytes(self.coreset_bytes)}",
                f"  solver: sequential"
                f" alpha={SEQ_ALPHA[self.problem.measure]}"
                f" ({self.problem.measure}), stateless — session reuse via"
                " serving.OnlineReranker",
            ]
            if actual:
                lines.extend(self._explain_actual())
            return "\n".join(lines)
        if self.mode == "dynamic":
            return "\n".join(self._explain_dynamic(actual))
        shape = (f"({self.n}, {self.d})" if self.n is not None
                 else f"stream (d={self.d if self.d is not None else '?'})")
        rows = ("?" if self.coreset_rows is None else
                f"{'<=' if k['kprime'] == 'auto' else ''}{self.coreset_rows}")
        bts = ("?" if self.coreset_bytes is None else
               f"{'<=' if k['kprime'] == 'auto' else ''}"
               f"{_fmt_bytes(self.coreset_bytes)}")
        cons = (f"yes ({self.matroid.__class__.__name__}, m={self.matroid.m})"
                if self.constrained else "no")
        lines = [
            "DiversityPlan",
            f"  mode: {self.mode} ({self.reason})",
            f"  problem: k={self.problem.k}, measure={self.problem.measure},"
            f" metric={self.problem.metric}, input={shape},"
            f" constrained={cons}",
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
            f" ({self.problem.measure})"
            + (f", feasible greedy + {self.execution.swap_rounds}"
               " swap rounds" if self.constrained else ""),
        ]
        if self.execution.resilience is not None:
            lines.append(
                f"  resilience: {self.execution.resilience.describe()}")
        if actual:
            lines.extend(self._explain_actual())
        return "\n".join(lines)

    def _explain_dynamic(self, actual: bool):
        """The reference's dynamic block, line for line (the ``layout``
        line says where the cover lives)."""
        from .core.sequential import SEQ_ALPHA

        k = self.knobs
        pol = k["rebuild"]
        shape = (f"({self.n}, {self.d})" if self.updates == 1
                 and self.n is not None else
                 f"update-stream ({self.updates} ops, "
                 f"d={self.d if self.d is not None else '?'})")
        lines = [
            "DiversityPlan",
            f"  mode: dynamic ({self.reason})",
            f"  problem: k={self.problem.k},"
            f" measure={self.problem.measure},"
            f" metric={self.problem.metric},"
            f" input={shape}, constrained=no",
            f"  index: leveled cover, {pol.levels} levels (radius"
            f" halving), query = finest level <= {k['kprime']} centers",
            f"  rebuild: {pol.describe()} (dirty levels re-certify"
            " incrementally between rebuilds)",
            f"  engine: b=1 (exact m=1 schedule on the level core-set),"
            f" chunk={k['chunk']}, use_pallas={k['use_pallas']}",
            f"  layout: {self.layout}",
            f"  predicted coreset: <={self.coreset_rows} rows,"
            f" <={_fmt_bytes(self.coreset_bytes)}"
            if self.coreset_bytes is not None else
            f"  predicted coreset: <={self.coreset_rows} rows",
            f"  solver: sequential"
            f" alpha={SEQ_ALPHA[self.problem.measure]}"
            f" ({self.problem.measure})",
        ]
        if self.execution.resilience is not None:
            lines.append(
                f"  resilience: {self.execution.resilience.describe()}")
        if actual:
            lines.extend(self._explain_actual())
        return lines

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


def _resolve_constraint(problem: ProblemSpec, streamed: bool):
    """Resolve (constrained, matroid), as the reference does: quotas and
    matroid are mutually exclusive, labels alone balance k across groups,
    and a streamed constrained source must spell the matroid out."""
    from .constrained import PartitionMatroid

    labels, matroid, quotas = problem.labels, problem.matroid, problem.quotas
    if matroid is None and quotas is None and labels is None:
        return False, None
    if matroid is not None and quotas is not None:
        raise ValueError("pass either matroid= or quotas=, not both")
    if labels is None and not streamed:
        raise ValueError("quotas=/matroid= require group_labels= "
                         "(ProblemSpec.labels=) for array input")
    if matroid is not None:
        mat = matroid
    elif quotas is not None:
        quotas = np.asarray(quotas, np.int64)
        if int(quotas.sum()) != problem.k:
            raise ValueError(
                f"sum(quotas)={int(quotas.sum())} != k={problem.k}")
        mat = PartitionMatroid(quotas)
    else:
        if streamed:
            raise ValueError("a constrained stream needs matroid= or "
                             "quotas= (labels arrive with the chunks)")
        from .data.selection import balanced_quotas
        if is_dtensor(labels):
            labels = labels.full_tensor()   # every rank of the mesh plans
        mat = PartitionMatroid(balanced_quotas(to_numpy(labels), problem.k))
    if mat.k != problem.k:
        raise ValueError(f"matroid.k={mat.k} != k={problem.k}")
    return True, mat


def plan(problem: ProblemSpec, execution: Optional[ExecutionSpec] = None
         ) -> Plan:
    """Compile (ProblemSpec, ExecutionSpec) into an inspectable ``Plan``.

    Pure resolution — nothing executes (a ``DTensor`` of labels alone is
    gathered for the default quotas, by every rank of its mesh).  Raises
    ``ValueError`` for the reference's rejected specs and ``RuntimeError``
    when ``device`` names a CUDA device that is absent.
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
    requests = updates = None
    if arr and problem.points.ndim == 3:
        # (requests, candidates, d) tensor — the serving-mode input shape
        requests, n, d = (int(s) for s in problem.points.shape)
    else:
        n = int(problem.points.shape[0]) if arr else None
        d = (int(problem.points.shape[1]) if arr and problem.points.ndim > 1
             else problem.dim)
    if not arr:
        # a materialized list of Insert/Delete ops is the dynamic-mode
        # input; classification and d-recovery read no payload
        from .dynamic.ops import is_update_stream, stream_dim
        if is_update_stream(problem.points):
            updates = len(problem.points)
            if d is None:
                d = stream_dim(problem.points)
    constrained, mat = _resolve_constraint(problem, streamed=not arr)

    # ---- mode ------------------------------------------------------------
    mesh = ex.mesh
    sharded = arr and is_dtensor(problem.points)
    num_red = ex.num_reducers
    if ex.mode != "auto":
        mode, reason = ex.mode, "requested"
        if mode == "mapreduce" and mesh is None and not (num_red or 0) > 1:
            if not sharded:
                raise ValueError("mode='mapreduce' needs mesh= or "
                                 "num_reducers > 1")
            mesh = problem.points.device_mesh
    elif updates is not None:
        mode, reason = ("dynamic",
                        "auto: update-stream input (insert/delete ops)")
    elif not arr:
        mode, reason = "streaming", "auto: chunk-iterator input"
    elif requests is not None:
        mode, reason = "serving", "auto: (requests, candidates, d) tensor"
    elif mesh is not None:
        mode, reason = "mapreduce", "auto: mesh provided"
    elif sharded:
        mode, reason = "mapreduce", "auto: input array is device-sharded"
        mesh = problem.points.device_mesh
    elif (num_red or 0) > 1:
        mode, reason = "mapreduce", f"auto: num_reducers={num_red}"
    elif (ex.memory_budget_bytes is not None
          and n * (d or 1) * _itemsize(problem.points)
          > ex.memory_budget_bytes):
        mode, reason = "streaming", (
            f"auto: input {n * (d or 1) * _itemsize(problem.points)} B "
            f"exceeds memory budget {ex.memory_budget_bytes} B")
    else:
        mode, reason = "batch", "auto: in-memory array"
    if sharded and mode != "mapreduce":
        raise ValueError(f"a DTensor input runs the mapreduce mesh path; "
                         f"pass points.full_tensor() for a {mode} run")
    if sharded and mesh is None:
        mesh = problem.points.device_mesh   # its rows already lie on ranks
    if mode != "mapreduce":
        mesh = None
    if updates is not None and mode != "dynamic":
        raise ValueError(f"an update stream (Insert/Delete ops) only "
                         f"supports mode='dynamic', got {mode!r}")
    if not arr and updates is None and mode != "streaming":
        raise ValueError(f"a chunk-iterator source only supports "
                         f"mode='streaming', got {mode!r}")
    if mode == "dynamic" and updates is None:
        if not (arr and problem.points.ndim == 2):
            raise ValueError(
                "mode='dynamic' needs an update stream (a list of "
                "repro_torch.Insert/repro_torch.Delete ops) or an (n, d) "
                "array (sugar for a one-insert stream)")
        updates = 1                   # the single-insert sugar
    if mode == "serving" and requests is None:
        raise ValueError("mode='serving' needs a 3-D (requests, candidates, "
                         "d) array of per-request candidate embeddings")
    if mode != "serving" and requests is not None:
        raise ValueError(f"a 3-D (requests, candidates, d) tensor only "
                         f"supports mode='serving', got {mode!r}")
    if mode == "serving":
        from .serving.rerank import GMM_PREFIX_MEASURES
        if constrained:
            raise ValueError(
                "mode='serving' is unconstrained — serve quota-constrained "
                "slates through repro_torch.serving.OnlineReranker("
                "matroid=...) sessions instead")
        if problem.measure not in GMM_PREFIX_MEASURES:
            raise ValueError(
                f"mode='serving' answers per-request slates with the "
                f"GMM-prefix engine; measure {problem.measure!r} is not "
                f"GMM-solvable (one of {GMM_PREFIX_MEASURES})")
        if n < problem.k:
            raise ValueError(f"k={problem.k} exceeds the {n} candidates "
                             f"per request")
        # knobs without a serving execution path must fail at plan time
        if ex.kprime not in ("auto", None):
            raise ValueError("kprime= has no serving path (stateless "
                             "per-request slates build no core-set)")
        if ex.b not in ("auto", 1):
            raise ValueError("mode='serving' runs the exact b=1 engine "
                             "per request; b= has no serving path")
        if ex.schedule is not None:
            raise ValueError("schedule= has no serving path")
        if ex.generalized or ex.smm_mode is not None:
            raise ValueError("generalized=/smm_mode= have no serving path")
    rebuild_pol = None
    if mode == "dynamic":
        from .dynamic import resolve_rebuild
        if constrained:
            raise ValueError(
                "mode='dynamic' is unconstrained — solve the surviving "
                "points through a constrained batch/streaming run instead")
        if not metric.is_metric:
            raise ValueError(
                f"metric {problem.metric!r} violates the triangle "
                "inequality; the dynamic cover structure needs a true "
                "metric")
        if ex.b not in ("auto", 1):
            raise ValueError("mode='dynamic' runs the exact b=1 engine on "
                             "the level core-set; b= has no dynamic path")
        if ex.schedule is not None:
            raise ValueError("schedule= has no dynamic path")
        if ex.generalized or ex.smm_mode is not None:
            raise ValueError("generalized=/smm_mode= have no dynamic path")
        if ex.mesh is not None or (num_red or 0) > 1:
            raise ValueError("mesh=/num_reducers= have no dynamic path (a "
                             "dynamic index is one long-lived "
                             "structure on one device)")
        rebuild_pol = resolve_rebuild(ex.rebuild)
    elif ex.rebuild not in ("auto", None):
        raise ValueError(f"rebuild= tunes the dynamic index and has no "
                         f"{mode} path")
    if constrained and (ex.generalized or ex.three_round):
        raise ValueError("generalized/three-round has no constrained path")
    if ex.three_round and (mode != "mapreduce" or mesh is None):
        # the simulated path's generalized scheme is the three-round
        # equivalent — spell it generalized=True there
        raise ValueError("three_round=True needs the mapreduce mesh path "
                         "(use generalized=True for the simulated path)")
    if ex.recursive and (mode != "mapreduce" or mesh is None or constrained):
        raise ValueError("recursive=True needs the unconstrained mapreduce "
                         "mesh path")
    if ex.recursive and "pod" not in tuple(mesh.mesh_dim_names or ()):
        raise ValueError("recursive scheme expects a 'pod' axis")
    if problem.weights is not None and (mode != "batch" or constrained):
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
        from .distributed.fault_tolerance import ResiliencePolicy
        if not isinstance(ex.resilience, ResiliencePolicy):
            raise TypeError("resilience= must be a "
                            "repro_torch.distributed.ResiliencePolicy, got "
                            f"{type(ex.resilience).__name__}")
        if mode in ("batch", "serving"):
            raise ValueError("resilience= applies to streaming and "
                             f"mapreduce runs ({mode} is one local dispatch "
                             "with nothing to retry or degrade to)")
        if (mode == "streaming" and constrained
                and ex.resilience.checkpoint_dir is not None):
            raise ValueError("checkpoint/resume is not yet supported for "
                             "constrained streams (retry/degrade are)")
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
    if kprime == "auto" and mode == "dynamic":
        # the level-induced core-set budget: deletions erode the cover, so
        # the dynamic default leaves more slack than the streaming state cap
        kprime = max(2 * k, 64)
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

    if mode == "dynamic":
        kp = int(kprime)
        knobs["rebuild"] = rebuild_pol
        return Plan(
            problem=problem, execution=ex, mode=mode, reason=reason,
            constrained=False, matroid=None, variant="plain", mesh=None,
            num_reducers=None, knobs=knobs,
            layout=(f"leveled cover on the device ({device}), "
                    f"{rebuild_pol.levels} levels, freeze cap "
                    f"{max(4 * kp, 256)} centers/level"),
            kprime_plan=f"kprime={kp} (dynamic core-set budget)",
            coreset_rows=kp, coreset_bytes=None if d is None else kp * d * 4,
            n=n, d=d, updates=updates)

    if mode == "serving":
        # stateless fused slates: no core-set, no reducers — the predicted
        # footprint is the (requests x k) slate tensor itself
        return Plan(
            problem=problem, execution=ex, mode=mode, reason=reason,
            constrained=False, matroid=None, variant="plain", mesh=None,
            num_reducers=None, knobs=knobs,
            layout=(f"multi-tenant vmap, {requests} requests x {n} "
                    f"candidates per dispatch"),
            kprime_plan="none (stateless per-request slate)",
            coreset_rows=requests * k, coreset_bytes=requests * k * d * 4,
            n=n, d=d, requests=requests)

    # ---- k' plan + layout + footprint ------------------------------------
    m_groups = mat.m if constrained else 1
    if mode == "mapreduce" and mesh is not None:
        from .core.distributed import _axis_size
        axes = _mesh_axes(ex)
        ell = int(np.prod([_axis_size(mesh, a) for a in axes]))
        # the reference's wording, its shard_map being torch.distributed here
        layout = (f"mesh torch.distributed over axes {axes}, {ell} reducers"
                  + (", 2-level recursive" if ex.recursive else ""))
    elif mode == "mapreduce":
        # the reference's wording: its reducers are a vmap over shards, here
        # the groups of one grouped-engine run
        ell = int(num_red)
        layout = (f"simulated mapreduce, {ell} reducers "
                  f"(vmap, partition={ex.partition})")
    elif mode == "streaming":
        ell = 1
        layout = (f"one pass, chunk={chunk}, "
                  f"state cap {m_groups}x({kprime}+1) centers")
    else:
        ell = 1
        layout = "single machine, one partition"
    if constrained:
        layout += f", {m_groups} matroid groups"
    if isinstance(kprime, (int, np.integer)):
        kp_num = int(kprime)
        kprime_plan = f"kprime={kp_num} (fixed)"
    else:
        kmax, miles = auto_milestones(k, n if n is not None else 10 ** 9)
        kp_num = kmax
        arrow = " -> ".join(str(c) for c in miles + [kmax])
        kprime_plan = (f"kprime=auto (milestones {arrow}, eps={eps_eff}, "
                       "x2 first step, secant-refined)")
    if mode == "mapreduce":
        kprime_plan += f", composed over {ell} reducers"
    if constrained:
        kprime_plan += f" x {m_groups} groups"
    rows_per = ell * m_groups * kp_num * (k if variant == "ext" else 1)
    bytes_ = None if d is None else rows_per * d * 4 + (
        rows_per * 4 if variant == "gen" else 0)
    return Plan(problem=problem, execution=ex, mode=mode, reason=reason,
                constrained=constrained, matroid=mat, variant=variant,
                mesh=mesh,
                num_reducers=(ell if mode == "mapreduce" and mesh is None
                              else None),
                knobs=knobs, layout=layout,
                kprime_plan=kprime_plan, coreset_rows=rows_per,
                coreset_bytes=bytes_, n=n, d=d)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _value_of(sol, measure: str, metric: str) -> float:
    from .core.measures import solution_value
    return solution_value(sol, measure, metric)


def _indices_of(plan_: Plan, pts, sol, sol_labels=None):
    """Thunk recovering distinct input-row indices for the solution (run
    lazily on first ``DiversityResult.indices`` access) from the device
    copy of the points (``pts``; None moves the input array there on first
    access), or None when the path cannot recover rows (a chunk iterator, a
    generalized core-set).  With ``sol_labels`` (a constrained stream) a
    solution point only matches rows of its own group."""
    if plan_.n is None or plan_.variant == "gen":
        return None

    def match():
        from .data.selection import _match_rows
        rows = pts if pts is not None else as_points(
            plan_.problem.points, plan_.knobs["device"])
        if sol_labels is not None and plan_.problem.labels is not None:
            return _match_rows(rows, sol, plan_.problem.k,
                               row_labels=plan_.problem.labels,
                               sol_labels=sol_labels)
        return _match_rows(rows, sol, plan_.problem.k)

    return match


def _chunks_of(problem: ProblemSpec, chunk: int, constrained: bool = False):
    """The points source as an iterator of chunks (of ``(chunk, labels)``
    pairs for a constrained run).  A tensor is sliced where it lies (a
    tensor on the card is never copied to the host); any other array is
    cast per chunk, never as a whole, so the memory-budget streaming path
    holds one chunk at a time."""
    pts = problem.points
    if not _is_array(pts):
        yield from pts
        return
    lab = None if problem.labels is None else to_numpy(problem.labels)
    step = chunk if chunk and chunk > 0 else 4096
    for i in range(0, int(pts.shape[0]), step):
        part = pts[i:i + step]
        part = part if isinstance(part, torch.Tensor) else \
            np.asarray(part, np.float32)
        yield (part, lab[i:i + step]) if constrained else part


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
    solver on the core-set (phases stream / finalize / solve / value).

    Under a ``ResiliencePolicy`` every chunk is one ``run_unit`` (retried,
    dropped or raised as the policy says); with ``checkpoint_dir`` the SMM
    state is checkpointed every ``checkpoint_every`` chunks and a rerun
    restores the latest checkpoint and skips the chunks already folded in
    (the state is chunk-invariant, so the resumed run continues
    bit-identically).  A run that dropped chunks stamps its certificate
    with the chunk coverage ("shards" reads "chunks")."""
    from .core.sequential import solve_on_coreset
    from .core.smm import StreamingCoreset

    p, kb = plan_.problem, plan_.knobs
    pol = plan_.execution.resilience
    smm: Optional[StreamingCoreset] = None
    dim = plan_.d
    t = time.perf_counter()
    n_seen = 0
    report = mgr = None
    chunks_done = 0          # chunks already folded in (restored on resume)
    lost_points = 0
    if pol is not None:
        from .distributed.fault_tolerance import ResilienceReport, run_unit
        report = ResilienceReport(scope="chunk", policy=pol.describe())
        if pol.checkpoint_dir is not None:
            from .checkpoint import CheckpointManager
            mgr = CheckpointManager(pol.checkpoint_dir, keep_k=2)
            smm, step = StreamingCoreset.restore(
                mgr, device=kb["device"], use_pallas=kb["use_pallas"])
            if smm is not None:
                chunks_done = step
                n_seen = smm.n_seen
                dim = smm.dim
                report.resumed_from = step
    for j, chunk in enumerate(_chunks_of(p, kb["chunk"])):
        if j < chunks_done:
            continue
        chunk = as_points(chunk, kb["device"])
        if chunk.ndim < 2:
            chunk = chunk.reshape(1, -1)
        if smm is None:
            dim = chunk.shape[1] if dim is None else dim
            smm = StreamingCoreset(p.k, int(kb["kprime"]), dim,
                                   metric=p.metric, mode=plan_.variant,
                                   eps=kb["eps"], device=kb["device"],
                                   use_pallas=kb["use_pallas"])
        if pol is None:
            smm.update(chunk)
        elif not run_unit(lambda: smm.update(chunk), pol, point=f"chunk:{j}",
                          unit=j, report=report):
            lost_points += chunk.shape[0]
        n_seen += chunk.shape[0]
        chunks_done = j + 1
        if mgr is not None and chunks_done % pol.checkpoint_every == 0:
            smm.save(mgr, chunks_done)
            report.checkpoints_written += 1
    if smm is None:
        raise ValueError("empty stream")
    t = tr.phase("stream", t, sync=smm.state)
    cs = smm.finalize()
    if report is not None and report.degraded:
        # dropped chunks: the core-set covers the consumed points only
        failed = set(report.failed)
        cs = cs._replace(cert=dataclasses.replace(
            cs.cert, degraded=True,
            surviving_shards=tuple(i for i in range(chunks_done)
                                   if i not in failed),
            total_shards=chunks_done, points_covered=n_seen - lost_points,
            points_total=n_seen))
    t = tr.phase("finalize", t, sync=cs)
    sol = solve_on_coreset(cs, p.k, p.measure, metric=p.metric)
    t = tr.phase("solve", t, sync=sol)
    value = _value_of(sol, p.measure, p.metric)
    tr.phase("value", t)
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=_indices_of(plan_, None, sol), labels=None, cert=cs.cert,
        coreset=cs,
        telemetry=tr.annotate(mode="streaming", n_seen=n_seen,
                              merges=len(smm.phase_log),
                              coreset_size=getattr(cs, "size", None)),
        plan=plan_)


def _run_batch_constrained(plan_: Plan, tr) -> DiversityResult:
    """Per-group core-sets on the grouped engine, then the feasible greedy +
    swap solver on their union; the indices come straight from the
    core-set (no row matching)."""
    from .constrained import grouped_coreset
    from .constrained.solver import solve_and_value

    p, kb, mat = plan_.problem, plan_.knobs, plan_.matroid
    t = time.perf_counter()
    pts = as_points(p.points, kb["device"])     # the one move to the device
    labels_np = np.asarray(to_numpy(p.labels))
    cs = grouped_coreset(pts, labels_np, mat.m, mat.k, kb["kprime"],
                         measure=p.measure, metric=p.metric,
                         use_pallas=kb["use_pallas"], b=kb["b"],
                         chunk=kb["chunk"], schedule=kb["schedule"],
                         eps=kb["eps"], tau=plan_.execution.tau,
                         cliff=plan_.execution.cliff, sprint=kb["sprint"])
    t = tr.phase("coreset", t, sync=cs)
    cand_idx, cand_labels = cs.flatten()
    cand = pts.index_select(0, torch.as_tensor(cand_idx, device=pts.device))
    sel, value = solve_and_value(cand, cand_labels, measure=p.measure,
                                 matroid=mat, metric=p.metric,
                                 swap_rounds=plan_.execution.swap_rounds)
    tr.phase("solve", t)
    indices = np.asarray(cand_idx[sel])
    return DiversityResult(
        solution=to_numpy(cand[torch.as_tensor(sel, device=pts.device)]),
        value=value, _indices=indices, labels=labels_np[indices],
        cert=cs.cert, coreset=cs,
        telemetry=tr.annotate(mode="batch", coreset_size=cs.size),
        plan=plan_)


def _run_streaming_constrained(plan_: Plan, tr) -> DiversityResult:
    """One SMM state per group over the labelled chunks, then the feasible
    greedy + swap solver on the union (phases stream / finalize / solve).
    Under a ``ResiliencePolicy`` every chunk is one ``run_unit``."""
    from .constrained import FairStreamingCoreset
    from .constrained.solver import solve_and_value

    p, kb, mat = plan_.problem, plan_.knobs, plan_.matroid
    pol = plan_.execution.resilience
    dim = plan_.d
    smm: Optional[FairStreamingCoreset] = None
    t = time.perf_counter()
    n_seen = 0
    report = None
    if pol is not None:
        from .distributed.fault_tolerance import ResilienceReport, run_unit
        report = ResilienceReport(scope="chunk", policy=pol.describe())
    for j, (chunk, labels) in enumerate(_chunks_of(p, kb["chunk"],
                                                   constrained=True)):
        chunk = as_points(chunk, kb["device"])
        if chunk.ndim < 2:
            chunk = chunk.reshape(1, -1)
        if smm is None:
            dim = chunk.shape[1] if dim is None else dim
            smm = FairStreamingCoreset(matroid=mat, kprime=int(kb["kprime"]),
                                       dim=dim, metric=p.metric,
                                       mode=plan_.variant, eps=kb["eps"],
                                       device=kb["device"],
                                       use_pallas=kb["use_pallas"])
        if pol is None:
            smm.update(chunk, labels)
        else:
            run_unit(lambda: smm.update(chunk, labels), pol,
                     point=f"chunk:{j}", unit=j, report=report)
        n_seen += chunk.shape[0]
    if smm is None:
        raise ValueError("empty stream")
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    t = tr.phase("stream", t, sync=smm.state)
    cand_pts, cand_labels = smm.finalize()
    cert = smm.certificate()
    t = tr.phase("finalize", t, sync=cand_pts)
    sel, value = solve_and_value(cand_pts, cand_labels, measure=p.measure,
                                 matroid=mat, metric=p.metric,
                                 swap_rounds=plan_.execution.swap_rounds)
    tr.phase("solve", t)
    sol = cand_pts[torch.as_tensor(sel, device=cand_pts.device)]
    sol_lab = cand_labels[sel]
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=_indices_of(plan_, None, sol, sol_labels=sol_lab),
        labels=np.asarray(sol_lab), cert=cert, coreset=None,
        telemetry=tr.annotate(mode="streaming", n_seen=n_seen,
                              coreset_size=int(cand_pts.shape[0])),
        plan=plan_)


def _run_dynamic(plan_: Plan, tr) -> DiversityResult:
    """Fold the update stream into a ``DynamicIndex`` on the run's device
    (one resilience unit per op, ``point="update:j"``), then answer one
    certified query on the level-induced core-set (phases updates / query
    / value).  With ``ResiliencePolicy(checkpoint_dir=...)`` the index
    checkpoints every ``checkpoint_every`` ops and a killed run resumes
    bit-identically: restore skips the already-applied prefix and replays
    the rest (maintenance is deterministic).  A run that dropped ops
    stamps its certificate with the op coverage ("shards" reads
    "updates")."""
    from .dynamic import DynamicIndex, as_update_ops

    p, kb = plan_.problem, plan_.knobs
    pol = plan_.execution.resilience
    ops = as_update_ops(p.points)
    dyn: Optional[DynamicIndex] = None
    t = time.perf_counter()
    report = mgr = None
    ops_done = 0             # ops already applied (restored on resume)
    if pol is not None:
        from .distributed.fault_tolerance import ResilienceReport, run_unit
        report = ResilienceReport(scope="update", policy=pol.describe())
        if pol.checkpoint_dir is not None:
            from .checkpoint import CheckpointManager
            mgr = CheckpointManager(pol.checkpoint_dir, keep_k=2)
            dyn, step = DynamicIndex.restore(mgr, device=kb["device"],
                                             use_pallas=kb["use_pallas"])
            if dyn is not None:
                ops_done = step
                report.resumed_from = step
    for j, op in enumerate(ops):
        if j < ops_done:
            continue
        if dyn is None:
            dyn = DynamicIndex(dim=plan_.d, metric=p.metric,
                               policy=kb["rebuild"],
                               budget=int(kb["kprime"]),
                               device=kb["device"],
                               use_pallas=kb["use_pallas"])
        if pol is None:
            dyn.apply(op)
        else:
            run_unit(lambda: dyn.apply(op), pol, point=f"update:{j}",
                     unit=j, report=report)
        ops_done = j + 1
        if mgr is not None and ops_done % pol.checkpoint_every == 0:
            dyn.save(mgr, ops_done)
            report.checkpoints_written += 1
    if dyn is None or dyn.n_alive == 0:
        raise ValueError("empty update stream")
    t = tr.phase("updates", t)
    q = dyn.query(p.k, budget=int(kb["kprime"]), measure=p.measure,
                  eps=kb["eps"], chunk=kb["chunk"])
    cert = q.cert
    if report is not None and report.degraded:
        # dropped updates: the index reflects the applied ops only — stamp
        # the certificate with the op-level coverage accounting
        failed = set(report.failed)
        cert = dataclasses.replace(
            cert, degraded=True,
            surviving_shards=tuple(i for i in range(ops_done)
                                   if i not in failed),
            total_shards=ops_done)
    cs = q.coreset._replace(cert=cert)
    t = tr.phase("query", t, sync=cs.points)
    value = _value_of(q.solution, p.measure, p.metric)
    tr.phase("value", t)
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    return DiversityResult(
        solution=to_numpy(q.solution), value=value,
        _indices=np.asarray(q.ids), labels=None, cert=cert, coreset=cs,
        telemetry=tr.annotate(mode="dynamic", n_live=dyn.n_alive,
                              updates=len(ops), rebuilds=dyn.rebuilds,
                              query_level=q.level,
                              coreset_size=q.coreset.size),
        plan=plan_)


def _mesh_indices(plan_: Plan, sol, sol_labels=None):
    """Row recovery of a mesh run.  A DTensor input's rows lie on the
    ranks, so every rank matches now, together
    (``core.distributed._mesh_match_rows``: a collective, which a lazy
    thunk read on some ranks only would hang); a full array every rank
    holds is matched locally on first access, as in the other modes."""
    p, ex = plan_.problem, plan_.execution
    if not (is_dtensor(p.points) or is_dtensor(p.labels)):
        return _indices_of(plan_, None, sol, sol_labels=sol_labels)
    from .core.distributed import _local_rows, _mesh_match_rows, _mesh_setup

    axes = _mesh_axes(ex)
    comm, rows, n, _ = _mesh_setup(p.points, plan_.mesh, axes,
                                   plan_.knobs["device"])
    row_labels = None
    if sol_labels is not None and p.labels is not None:
        row_labels = to_numpy(_local_rows(p.labels, plan_.mesh, comm, axes,
                                          n))
    return _mesh_match_rows(comm, rows, sol, p.k, row_labels=row_labels,
                            sol_labels=sol_labels)


def _run_mapreduce_mesh(plan_: Plan, tr) -> DiversityResult:
    """The mesh run on this rank (every rank of the mesh runs it): the
    two- or three-round scheme in one ``rounds`` phase, or the recursive
    scheme's ``rounds``, ``solve`` and ``value`` phases, as in the
    reference.  Three-round instantiation may fall back to kernel-point
    replicas that are not input rows, so it recovers no indices."""
    from .core.distributed import _mesh_recursive, _mr_diversity_impl
    from .core.sequential import solve_on_coreset

    p, kb, ex = plan_.problem, plan_.knobs, plan_.execution
    knobs = dict(metric=p.metric, use_pallas=kb["use_pallas"], b=kb["b"],
                 chunk=kb["chunk"],
                 eps=0.1 if kb["eps"] is None else kb["eps"], tau=ex.tau,
                 cliff=ex.cliff, device=kb["device"],
                 resilience=ex.resilience)
    three_round = ex.three_round or plan_.variant == "gen"
    t = time.perf_counter()
    if ex.recursive:
        cs, report, _, _ = _mesh_recursive(p.points, p.k, kb["kprime"],
                                           p.measure, plan_.mesh, **knobs)
        t = tr.phase("rounds", t, sync=cs)
        sol = solve_on_coreset(cs, p.k, p.measure, metric=p.metric)
        t = tr.phase("solve", t, sync=sol)
        value = _value_of(sol, p.measure, p.metric)
        tr.phase("value", t)
    else:
        sol, value, cs, report = _mr_diversity_impl(
            p.points, p.k, p.measure, plan_.mesh, kprime=kb["kprime"],
            data_axes=ex.data_axes, three_round=three_round, **knobs)
        tr.phase("rounds", t, sync=sol)
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=None if three_round else _mesh_indices(plan_, sol),
        labels=None, cert=getattr(cs, "cert", None), coreset=cs,
        telemetry=tr.annotate(mode="mapreduce",
                              coreset_size=getattr(cs, "size", None)),
        plan=plan_)


def _run_mapreduce(plan_: Plan, tr) -> DiversityResult:
    """The simulated ℓ-reducer run (one ``rounds`` phase: probe, round 1,
    solve and, for the generalized scheme, instantiation), or the mesh run.
    Generalized instantiation may fall back to kernel-point replicas that
    are not input rows, so it recovers no indices."""
    from .core.distributed import _simulate_mr_impl

    if plan_.mesh is not None:
        return _run_mapreduce_mesh(plan_, tr)
    p, kb, ex = plan_.problem, plan_.knobs, plan_.execution
    t = time.perf_counter()
    pts = as_points(p.points, kb["device"])     # the one move to the device
    sol, value, cs, report = _simulate_mr_impl(
        pts, p.k, p.measure, num_reducers=plan_.num_reducers,
        kprime=kb["kprime"], metric=p.metric,
        generalized=plan_.variant == "gen", partition=ex.partition,
        seed=ex.seed, b=kb["b"], chunk=kb["chunk"],
        eps=0.1 if kb["eps"] is None else kb["eps"], tau=ex.tau,
        cliff=ex.cliff, use_pallas=kb["use_pallas"],
        resilience=ex.resilience)
    tr.phase("rounds", t, sync=sol)
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    return DiversityResult(
        solution=to_numpy(sol), value=value,
        _indices=_indices_of(plan_, pts, sol), labels=None,
        cert=getattr(cs, "cert", None), coreset=cs,
        telemetry=tr.annotate(mode="mapreduce",
                              coreset_size=getattr(cs, "size", None)),
        plan=plan_)


def _run_mapreduce_constrained(plan_: Plan, tr) -> DiversityResult:
    """The simulated ℓ-reducer constrained run, or the mesh run on this
    rank (one ``rounds`` phase)."""
    from .constrained.mapreduce import (_mr_fair_diversity_impl,
                                        _simulate_fair_mr_impl)

    p, kb, ex = plan_.problem, plan_.knobs, plan_.execution
    knobs = dict(matroid=plan_.matroid, measure=p.measure,
                 kprime=kb["kprime"], metric=p.metric,
                 swap_rounds=ex.swap_rounds, b=kb["b"], chunk=kb["chunk"],
                 eps=0.1 if kb["eps"] is None else kb["eps"], tau=ex.tau,
                 cliff=ex.cliff, use_pallas=kb["use_pallas"],
                 resilience=ex.resilience)
    t = time.perf_counter()
    if plan_.mesh is not None:
        sol, sol_lab, value, cert, report = _mr_fair_diversity_impl(
            p.points, p.labels, mesh=plan_.mesh, data_axes=ex.data_axes,
            device=kb["device"], **knobs)
    else:
        pts = as_points(p.points, kb["device"])  # the one move to the device
        sol, sol_lab, value, cert, report = _simulate_fair_mr_impl(
            pts, to_numpy(p.labels), num_reducers=plan_.num_reducers,
            partition=ex.partition, seed=ex.seed, **knobs)
    if report is not None:
        tr.annotate(resilience=report.to_dict())
    tr.phase("rounds", t, sync=sol)
    indices = (_mesh_indices(plan_, sol, sol_labels=sol_lab)
               if plan_.mesh is not None else
               _indices_of(plan_, pts, sol, sol_labels=sol_lab))
    return DiversityResult(
        solution=to_numpy(sol), value=value, _indices=indices,
        labels=np.asarray(sol_lab), cert=cert, coreset=None,
        telemetry=tr.annotate(mode="mapreduce"), plan=plan_)


def _run_serving(plan_: Plan, tr) -> DiversityResult:
    """Stateless fused multi-tenant rerank: one grouped engine run answers
    every request's exact-GMM slate.  ``solution`` is (R, k, d),
    ``indices`` (R, k) rows into each request's candidate set and ``value``
    the mean per-request diversity objective (per-request values ride in
    ``telemetry["values"]``)."""
    from .serving.rerank import rerank_batched

    p, kb = plan_.problem, plan_.knobs
    t = time.perf_counter()
    pts = as_points(p.points, kb["device"])     # the one move to the device
    out = rerank_batched(pts, p.k, measure=p.measure, metric=p.metric,
                         chunk=kb["chunk"], use_pallas=kb["use_pallas"])
    t = tr.phase("rerank", t)
    idx = torch.as_tensor(out.indices, device=pts.device)
    sol = to_numpy(torch.gather(
        pts, 1, idx[:, :, None].expand(-1, -1, pts.shape[2])))
    tr.phase("value", t)
    return DiversityResult(
        solution=sol, value=float(np.mean(out.values)),
        _indices=np.asarray(out.indices), labels=None, cert=None,
        coreset=None,
        telemetry=tr.annotate(mode="serving", requests=int(pts.shape[0]),
                              values=out.values.tolist(),
                              radii=out.radii.tolist()),
        plan=plan_)


def _execute(plan_: Plan) -> DiversityResult:
    from . import obs

    tr = obs.trace_from_spec(plan_.execution.trace)
    if plan_.mode == "serving":
        run = _run_serving    # plan() rejects constrained serving
    elif plan_.mode == "dynamic":
        run = _run_dynamic    # plan() rejects constrained dynamic
    elif plan_.mode == "mapreduce":
        run = (_run_mapreduce_constrained if plan_.constrained
               else _run_mapreduce)
    elif plan_.constrained:
        run = (_run_streaming_constrained if plan_.mode == "streaming"
               else _run_batch_constrained)
    else:
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
