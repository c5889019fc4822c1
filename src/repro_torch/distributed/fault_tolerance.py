"""Fault tolerance & straggler mitigation for long runs (port of
``repro.distributed.fault_tolerance``; pure Python apart from the
checkpoint and tensor-copy helpers).

The paper's composable core-set design makes diversity maximization
unusually forgiving of partial failure: a lost reducer costs only that
shard's *coverage* — the surviving per-shard core-sets still compose into a
valid (if partial) core-set of the surviving points — and a streaming run's
entire progress is captured by its ``SMMState`` + phase log, which is
exactly a resume checkpoint.  This module turns those observations into an
execution policy:

* ``ResiliencePolicy`` — the one knob surface (``ExecutionSpec(resilience=
  ...)``): max retries with exponential backoff, a per-reducer deadline via
  ``StragglerPolicy`` (optionally speculating a re-run), streaming
  checkpoint cadence through ``CheckpointManager``, and the
  ``on_failure="retry"|"degrade"|"raise"`` disposition.
* ``FailureInjector`` — deterministic *scoped* fault injection
  (``"reducer:i"`` / ``"chunk:j"`` points, legacy integer training steps,
  or a seeded-random rate), used by the fault-injection matrix tests to
  assert bit-identical recovery and certified degradation.
* ``run_resilient`` — the generic retry/degrade loop the simulated
  MapReduce reducer paths (``core.distributed``, ``constrained.mapreduce``)
  drive, producing a ``ResilienceReport`` that the facade surfaces as
  ``telemetry.extras["resilience"]``.
* ``TrainingSupervisor`` — wraps the training step loop: periodic async
  checkpoints, auto-resume from the latest complete checkpoint, step
  deadline accounting, all configured by the same ``ResiliencePolicy``.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
import zlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import _rebuild


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministic scoped fault injection (each point fires once).

    ``fail_at`` holds *injection points*: scoped strings such as
    ``"reducer:3"`` (simulated-MR reducer 3), ``"chunk:7"`` (streaming chunk
    7) or ``"round:mr.round1"`` (a whole sharded round), plus legacy integer
    training-step numbers for ``TrainingSupervisor``.  ``rate`` adds
    seeded-random injection on top: a point whose deterministic coin
    (crc32 of ``"{seed}:{point}"``) falls below ``rate`` also fails, once.
    """
    fail_at: tuple = ()
    rate: float = 0.0
    seed: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, point):
        if point in self._fired:
            return
        trigger = point in self.fail_at
        if not trigger and self.rate > 0.0:
            coin = zlib.crc32(f"{self.seed}:{point}".encode()) / 2 ** 32
            trigger = coin < self.rate
        if trigger:
            self._fired.add(point)
            raise InjectedFailure(f"injected failure at {point}")

    @property
    def fired(self) -> tuple:
        """Points that have fired so far (stable order, stringified)."""
        return tuple(sorted(str(p) for p in self._fired))


@dataclasses.dataclass
class StragglerPolicy:
    """Trailing-median step-deadline policy (shared by the supervisor and
    the MapReduce reducer paths).

    A step is flagged when its wall time exceeds ``deadline_factor`` × the
    median of the last ``window`` recorded steps (once ``min_history`` have
    accumulated).  The first ``warmup_steps`` observations are excluded from
    BOTH the median history and flagging: they carry the kernel build and
    the CUDA context start (jit compilation in the reference), so on
    a fresh process the first step is routinely 10-100× the steady-state
    time and would instantly poison the median / fire a spurious straggler.
    """
    deadline_factor: float = 3.0
    min_history: int = 5
    window: int = 20
    warmup_steps: int = 1
    _times: List[float] = dataclasses.field(default_factory=list)
    _seen: int = 0

    def observe(self, dt: float) -> bool:
        """Record one step's wall time; True iff it breached the deadline."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False                 # compile-laden step: never counted
        flagged = False
        if len(self._times) >= self.min_history:
            med = statistics.median(self._times[-self.window:])
            flagged = dt > self.deadline_factor * med
        self._times.append(dt)
        return flagged

    @property
    def history(self) -> tuple:
        return tuple(self._times)


_ON_FAILURE = ("retry", "degrade", "raise")


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """HOW a run survives faults.  Pass as ``ExecutionSpec(resilience=...)``.

    ``on_failure`` is the disposition when a unit of work (a simulated-MR
    reducer, a streaming chunk, a sharded round, a training step) raises:

    * ``"retry"`` — re-run the unit up to ``max_retries`` times with
      exponential backoff (``backoff_s * 2**attempt`` seconds), then raise.
      Units are deterministic, so a transient failure recovers
      *bit-identically* (asserted by the fault-injection matrix tests).
    * ``"degrade"`` — drop the unit and continue on the survivors: the
      composable core-set design means the surviving reducers' core-sets
      still merge into a valid core-set of the surviving shards, returned
      with a ``RadiusCertificate`` marked ``degraded=True`` and
      surviving-shard coverage accounting.
    * ``"raise"`` — propagate immediately (the pre-resilience behavior).

    ``deadline_factor`` arms a per-unit ``StragglerPolicy`` deadline
    (``None`` disables it); ``speculate=True`` additionally re-runs a
    deadline-breaching straggler once (results are deterministic, so
    speculation never changes the answer — it trades compute for tail
    latency).  ``checkpoint_dir``/``checkpoint_every`` arm periodic
    checkpoints through ``CheckpointManager`` — every ``checkpoint_every``
    chunks for a streaming run, every ``checkpoint_every`` steps for the
    ``TrainingSupervisor`` — so a killed run resumes from the latest
    complete checkpoint instead of recomputing from scratch.
    ``injector`` threads a ``FailureInjector`` through every injection
    point (tests / chaos drills).
    """
    max_retries: int = 2
    backoff_s: float = 0.0
    on_failure: str = "retry"
    deadline_factor: Optional[float] = None
    speculate: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    injector: Optional[FailureInjector] = None

    def __post_init__(self):
        if self.on_failure not in _ON_FAILURE:
            raise ValueError(f"on_failure must be one of {_ON_FAILURE}, "
                             f"got {self.on_failure!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, "
                             f"got {self.checkpoint_every}")

    def straggler_policy(self, **kw) -> Optional[StragglerPolicy]:
        """A fresh deadline tracker per run (None when deadlines are off)."""
        if self.deadline_factor is None:
            return None
        return StragglerPolicy(deadline_factor=self.deadline_factor, **kw)

    def backoff(self, attempt: int) -> float:
        """Seconds to sleep before retry ``attempt`` (0-based): exponential
        ``backoff_s * 2**attempt``."""
        return self.backoff_s * (2.0 ** attempt)

    def describe(self) -> str:
        """One-line rendering for ``plan.explain()`` (golden-tested)."""
        dl = ("off" if self.deadline_factor is None else
              f"{self.deadline_factor:g}x median"
              + (" + speculate" if self.speculate else ""))
        ck = ("off" if self.checkpoint_dir is None else
              f"every {self.checkpoint_every} -> {self.checkpoint_dir}")
        inj = "" if self.injector is None else ", injector=armed"
        return (f"on_failure={self.on_failure}, max_retries="
                f"{self.max_retries}, backoff={self.backoff_s:g}s, "
                f"deadline={dl}, checkpoint={ck}{inj}")


@dataclasses.dataclass
class ResilienceReport:
    """What the resilient loop actually did — surfaced by the facade as
    ``result.telemetry.extras["resilience"]`` (mirrors ``mr_stragglers``)."""
    scope: str                       # "reducer" | "chunk" | "round"
    units: int = 0                   # work units the loop ran
    retries: int = 0                 # re-run attempts after a failure
    failures_injected: int = 0       # InjectedFailure count (chaos drills)
    recovered: int = 0               # units that failed then succeeded
    failed: List[int] = dataclasses.field(default_factory=list)  # dropped
    stragglers: List[int] = dataclasses.field(default_factory=list)
    speculative_reruns: int = 0
    checkpoints_written: int = 0
    resumed_from: Optional[int] = None   # checkpoint step a resume started at
    policy: str = ""

    @property
    def survivors(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.units) if i not in self.failed)

    @property
    def degraded(self) -> bool:
        return bool(self.failed)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["degraded"] = self.degraded
        return out


def run_resilient(n: int, run_one: Callable[[int], Any],
                  policy: ResiliencePolicy, *, scope: str = "reducer",
                  report: Optional[ResilienceReport] = None,
                  ) -> Tuple[List[Any], ResilienceReport]:
    """Run ``run_one(i)`` for ``i in range(n)`` under ``policy``.

    Each unit is retried with exponential backoff (``on_failure="retry"``),
    dropped into the ``failed`` list (``"degrade"`` — its result slot is
    ``None``) or allowed to propagate (``"raise"``).  A unit whose wall time
    breaches the policy deadline is recorded as a straggler and, with
    ``speculate=True``, re-run once (deterministic work: the re-run result
    is identical, so speculation only affects wall-clock).  Counters
    (``retries``/``failures_injected``/``reducers_recovered``) report to the
    active ``RunTrace``.
    """
    from ..obs.trace import count as _count

    rep = report or ResilienceReport(scope=scope, policy=policy.describe())
    rep.units = n
    straggler = policy.straggler_policy(min_history=3)
    results: List[Any] = [None] * n
    for i in range(n):
        point = f"{scope}:{i}"
        attempt = 0
        while True:
            try:
                if policy.injector is not None:
                    policy.injector.maybe_fail(point)
                t0 = time.perf_counter()
                out = run_one(i)
                dt = time.perf_counter() - t0
            except Exception as e:
                if isinstance(e, InjectedFailure):
                    rep.failures_injected += 1
                    _count("failures_injected")
                if policy.on_failure == "raise":
                    raise
                if policy.on_failure == "degrade":
                    rep.failed.append(i)
                    break
                if attempt >= policy.max_retries:
                    raise
                time.sleep(policy.backoff(attempt))
                attempt += 1
                rep.retries += 1
                _count("retries")
                continue
            if attempt:
                rep.recovered += 1
                if scope == "reducer":
                    _count("reducers_recovered")
            if straggler is not None and straggler.observe(dt):
                rep.stragglers.append(i)
                if policy.speculate:
                    out = run_one(i)     # deterministic: identical result
                    rep.speculative_reruns += 1
            results[i] = out
            break
    return results, rep


def run_unit(run: Callable[[], Any], policy: ResiliencePolicy, *,
             point: str, unit: int, report: ResilienceReport) -> bool:
    """One retryable unit of a host-driven loop (a streaming chunk).

    The injection point fires BEFORE ``run``, so a retried unit replays
    against untouched state — bit-identical recovery for the chunk loop,
    whose SMM state only mutates inside ``run``.  Returns True when the
    unit ran, False when ``on_failure="degrade"`` dropped it (recorded in
    ``report.failed``)."""
    from ..obs.trace import count as _count

    report.units += 1
    attempt = 0
    while True:
        try:
            if policy.injector is not None:
                policy.injector.maybe_fail(point)
            run()
        except Exception as e:
            if isinstance(e, InjectedFailure):
                report.failures_injected += 1
                _count("failures_injected")
            if policy.on_failure == "raise":
                raise
            if policy.on_failure == "degrade":
                report.failed.append(unit)
                return False
            if attempt >= policy.max_retries:
                raise
            time.sleep(policy.backoff(attempt))
            attempt += 1
            report.retries += 1
            _count("retries")
            continue
        if attempt:
            report.recovered += 1
        return True


def retry_call(fn: Callable[[], Any], policy: ResiliencePolicy, *,
               point: str, report: Optional[ResilienceReport] = None,
               agree: Optional[Callable[[bool], bool]] = None,
               ) -> Tuple[Any, ResilienceReport]:
    """Whole-unit retry wrapper for paths without per-reducer granularity
    (a mesh round is one collective dispatch — a failure
    there is retried as a round; ``degrade`` has nothing to drop to and is
    treated as retry-then-raise).  ``agree(failed)`` turns this process's
    outcome of an attempt into the outcome of every process running the
    unit (a mesh's ranks: True when any failed), so that they all retry,
    return or raise together."""
    from ..obs.trace import count as _count

    rep = report or ResilienceReport(scope="round",
                                     policy=policy.describe())
    rep.units += 1
    attempt = 0
    while True:
        out, err = None, None
        try:
            if policy.injector is not None:
                policy.injector.maybe_fail(point)
            out = fn()
        except Exception as e:
            err = e
            if isinstance(e, InjectedFailure):
                rep.failures_injected += 1
                _count("failures_injected")
        failed = err is not None if agree is None else agree(err is not None)
        if not failed:
            return out, rep
        if policy.on_failure == "raise" or attempt >= policy.max_retries:
            if err is None:
                raise RuntimeError(f"{point}: failed on another process "
                                   "running the unit")
            raise err
        time.sleep(policy.backoff(attempt))
        attempt += 1
        rep.retries += 1
        _count("retries")


def degraded_certificate(cert, *, kprime: int, radius: float,
                         survivors: Sequence[int], total: int,
                         per_shard: int):
    """Stamp (or mint) a ``RadiusCertificate`` recording a degraded merge:
    the surviving reducers' core-sets compose into a valid core-set of the
    surviving shards only, so the certificate carries ``degraded=True`` plus
    the surviving-shard coverage accounting (``points_covered`` counts
    shard rows, i.e. padded partitions)."""
    from ..core.adaptive import RadiusCertificate

    surv = tuple(int(i) for i in survivors)
    if cert is None:
        cert = RadiusCertificate(kprime=int(kprime), radius=float(radius),
                                 scale=0.0, ratio=0.0, kind="mapreduce")
    return dataclasses.replace(
        cert, degraded=True, surviving_shards=surv, total_shards=int(total),
        points_covered=per_shard * len(surv), points_total=per_shard * total)


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    resumes: int = 0
    stragglers: int = 0
    reshard_requests: int = 0
    final_step: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)


def _copy(tree):
    """``tree`` with every tensor leaf cloned."""
    return _rebuild(tree, lambda _, leaf: leaf.clone()
                    if isinstance(leaf, torch.Tensor) else leaf)


class TrainingSupervisor:
    """Fault-tolerant training loop driver, configured by the same
    ``ResiliencePolicy`` as the diversify paths (``checkpoint_every`` counts
    training steps here; ``max_retries`` caps process restarts)."""

    def __init__(self, ckpt: CheckpointManager, *,
                 policy: Optional[ResiliencePolicy] = None,
                 max_stragglers: int = 10):
        self.ckpt = ckpt
        self.policy = policy or ResiliencePolicy(max_retries=8,
                                                 deadline_factor=3.0)
        self.max_stragglers = max_stragglers
        self.report = SupervisorReport()
        self.straggler_policy = (self.policy.straggler_policy()
                                 or StragglerPolicy())

    def run(self, state, step_fn: Callable, num_steps: int,
            batch_fn: Callable):
        """state: pytree (params, opt_state).  step_fn(state, batch, step) ->
        (state, metrics).  batch_fn(step) -> batch (deterministic => restarts
        replay the same data order).

        Exactly-once-resume semantics: a failure restores the latest complete
        checkpoint, or — when none exists yet — the pristine entry state
        (snapshotted before the first step), never a partially-updated one.
        """
        # pristine entry state: a copy, since a step may update tensors in
        # place (so a replay starts from a copy of it too)
        state0 = _copy(state)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            start, state = (latest,
                            self.ckpt.restore(latest, state))
        restarts = 0
        step = start
        injector = self.policy.injector
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                if injector is not None:
                    injector.maybe_fail(step)
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch, step)
                dt = time.perf_counter() - t0
                self._track_straggler(dt)
                self.report.steps_run += 1
                self.report.losses.append(float(metrics["loss"]))
                step += 1
                if step % self.policy.checkpoint_every == 0 \
                        or step == num_steps:
                    self.ckpt.save(step, state, blocking=False)
            except InjectedFailure:
                restarts += 1
                self.report.resumes += 1
                if restarts > self.policy.max_retries:
                    raise
                time.sleep(self.policy.backoff(restarts - 1))
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state = self.ckpt.restore(latest, state)
                    step = latest
                else:
                    # no checkpoint yet: replay from the pristine entry
                    # state — NOT the partially-updated live state
                    state = _copy(state0)
                    step = 0
        self.ckpt.wait()
        self.report.final_step = step
        return state

    def _track_straggler(self, dt: float):
        if self.straggler_policy.observe(dt):
            self.report.stragglers += 1
            if self.report.stragglers >= self.max_stragglers:
                self.report.reshard_requests += 1
                self.report.stragglers = 0
