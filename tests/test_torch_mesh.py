"""The port's MapReduce mesh path over ``torch.distributed``, on four gloo
CPU ranks, against the reference's mesh path on a 4-device CPU mesh and
against the port's own simulated run at ℓ = 4 (contiguous).

One module fixture starts the four ranks once (a ``file://`` store under
the test's temporary directory, so no TCP port) and, beside them, one
subprocess running the reference on the same seeded numpy inputs
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  Every case runs
in both; each writes its results to files that the parametrised tests
below read.

What is held:

* against the port's simulated run at ℓ = 4 (``num_reducers=4``,
  contiguous, the CPU's plain path): the union, radius, certificate,
  picks, indices and value are equal (``torch.equal``), on every rank —
  round 1 of a rank is the simulated run's per-reducer unit;
* against the reference's mesh path: the same picks and rows, the radius,
  value and certificate floats within rtol 1e-4 (the reference's
  end-to-end parity; its lax sweeps sum in fp32, the port's in float64),
  integer-lattice inputs exactly equal, and equal counters on pinned
  knobs (``host_syncs`` differs on auto knobs, as the simulated tests
  state);
* the reference's ``ValueError``s, and ``explain()`` line for line except
  the layout line, which names ``torch.distributed`` where the reference's
  says ``shard_map``.  One difference is decided: ``recursive=True`` on a
  mesh without a ``pod`` axis raises ``ValueError`` from the port's
  ``plan()``, where the reference's ``plan()`` raises ``KeyError('pod')``.
"""
import contextlib
import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import textwrap
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest
import torch

WORLD = 4
K, KP = 6, 16
MEASURES = {"plain": "remote-edge", "ext": "remote-clique",
            "gen": "remote-clique"}
RTOL = 1e-4
SPAWN_TIMEOUT = 400

# every case of the fixture: name -> what runs (the worker and the
# reference script read the same table)
CORESET_CASES = [f"coreset_{mode}_b{b}" for mode in ("plain", "ext", "gen")
                 for b in ("1", "auto")]
FACADE_CASES = ["facade_plain", "facade_ext", "facade_auto",
                "facade_strided", "facade_three_round", "facade_lattice"]


@contextlib.contextmanager
def one_rank_mesh(store_dir, shape=(1,), names=("data",)):
    """A one-rank gloo process group (a ``file://`` store in
    ``store_dir``) and a CPU ``DeviceMesh`` over it, torn down on exit:
    the mesh path in the test process itself."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _inputs():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2000, 8)).astype(np.float32)
    lattice = rng.integers(-50, 51, size=(2000, 4)).astype(np.float32)
    labels = rng.integers(0, 3, size=2000).astype(np.int32)
    # over 8,192 rows the probe samples every other row: its sample rows
    # start at local row 0 on ranks 0 and 2 and at local row 1 on 1 and 3
    big = rng.normal(size=(16388, 4)).astype(np.float32)
    return {"pts": pts, "lattice": lattice, "labels": labels, "big": big}


_COMMON = textwrap.dedent("""
    import dataclasses, os, pickle, sys, traceback
    import numpy as np

    OUT, K, KP = sys.argv[1], 6, 16
    MEASURES = {"plain": "remote-edge", "ext": "remote-clique",
                "gen": "remote-clique"}
    data = dict(np.load(os.path.join(OUT, "inputs.npz")))
    PTS, LAT, LAB = data["pts"], data["lattice"], data["labels"]
    BIG = data["big"]

    def host(x):
        if x is None or isinstance(x, (int, float, str, bool)):
            return x
        if dataclasses.is_dataclass(x):
            return {f.name: host(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(host(v) for v in x)
        if hasattr(x, "_fields"):
            return {f: host(getattr(x, f)) for f in x._fields}
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    def result(res):
        return {"solution": np.asarray(res.solution),
                "value": float(res.value),
                "indices": None if res.indices is None
                else np.asarray(res.indices),
                "labels": None if res.labels is None
                else np.asarray(res.labels),
                "cert": host(res.cert), "coreset": host(res.coreset),
                "counters": dict(res.telemetry.counters),
                "extras": {k: v for k, v in res.telemetry.extras.items()
                           if k != "resilience"},
                "resilience": res.telemetry.extras.get("resilience"),
                "phases": [p["name"] for p in res.telemetry["phases"]],
                "explain": res.plan.explain()}

    def run_all(cases, suffix):
        failed = []
        for name, fn in cases:
            try:
                out = fn()
            except Exception as e:
                out = {"error": type(e).__name__, "message": str(e),
                       "trace": traceback.format_exc()}
                failed.append(name)
            with open(os.path.join(OUT, f"{name}.{suffix}.pkl"), "wb") as f:
                pickle.dump(out, f)
        return failed
""")

_RANK = _COMMON + textwrap.dedent("""
    import datetime
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    RANK, WORLD_SIZE = int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                            rank=RANK, world_size=WORLD_SIZE,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    import repro_torch
    from repro_torch.constrained import mr_grouped_coreset
    from repro_torch.core.distributed import (mr_coreset,
                                              mr_coreset_recursive)
    from repro_torch.distributed import FailureInjector, ResiliencePolicy
    from repro_torch.launch.mesh import data_axes, make_host_mesh, num_chips
    from repro_torch.obs.trace import RunTrace, activate

    MESH = init_device_mesh("cpu", (WORLD_SIZE,), mesh_dim_names=("data",))
    POD = init_device_mesh("cpu", (2, WORLD_SIZE // 2),
                           mesh_dim_names=("pod", "data"))
    HOST = make_host_mesh()
    PER = PTS.shape[0] // WORLD_SIZE

    def shard(x, mesh=MESH):
        local = torch.as_tensor(x[RANK * PER:(RANK + 1) * PER])
        return DTensor.from_local(local, mesh, [Shard(0)] * mesh.ndim,
                                  run_check=False)

    def traced(fn):
        tr = RunTrace(enabled=True)
        with activate(tr):
            out = fn()
        return out, dict(tr.counters)

    def coreset(mode, b):
        cs, counters = traced(lambda: mr_coreset(
            PTS, K, KP, MEASURES[mode], MESH, generalized=mode == "gen",
            b=b, device="cpu"))
        return {"coreset": host(cs), "counters": counters}

    def facade(points=PTS, measure="remote-edge", mesh=MESH, **kw):
        kw.setdefault("kprime", KP)
        kw.setdefault("b", 1)
        return result(repro_torch.diversify(
            points, k=K, measure=measure,
            execution=repro_torch.ExecutionSpec(
                mode="mapreduce", mesh=mesh, device="cpu", trace=True,
                **kw)))

    def constrained(points=PTS, **kw):
        return result(repro_torch.diversify(
            repro_torch.ProblemSpec(points=points, k=K, labels=LAB,
                                    quotas=[2, 2, 2], **kw),
            repro_torch.ExecutionSpec(mode="mapreduce", mesh=MESH,
                                      kprime=KP, b=1, device="cpu",
                                      trace=True)))

    def grouped(measure):
        cs, counters = traced(lambda: mr_grouped_coreset(
            PTS, LAB, 3, K, KP, measure, MESH, device="cpu"))
        return {"coreset": host(cs), "counters": counters}

    def resilient(fail_ranks):
        inj = FailureInjector(fail_at=("round:mr.round1",)
                              if RANK in fail_ranks else ())
        return facade(resilience=ResiliencePolicy(injector=inj))

    def probe(fault):
        # every call of the probe on this rank, and a fault injected into
        # it; the run's answer, or what it raised
        import repro_torch.core.adaptive as adaptive
        real, calls = adaptive.probe_engine_plan, []

        def counted(*args, **kw):
            calls.append(1)
            if fault:
                raise RuntimeError("injected probe fault")
            return real(*args, **kw)
        adaptive.probe_engine_plan = counted
        try:
            return {"result": facade(kprime="auto", b="auto"),
                    "calls": len(calls)}
        except Exception as e:
            return {"raised": (type(e).__name__, str(e)),
                    "calls": len(calls)}
        finally:
            adaptive.probe_engine_plan = real

    def errors():
        out = {}
        tries = {
            "n_mod_l": lambda: mr_coreset(PTS[:1998], K, KP, "remote-edge",
                                          MESH, device="cpu"),
            "recursive_no_pod": lambda: repro_torch.plan(
                repro_torch.ProblemSpec(points=PTS, k=K),
                repro_torch.ExecutionSpec(mode="mapreduce", mesh=MESH,
                                          recursive=True, device="cpu")),
            "recursive_constrained": lambda: repro_torch.plan(
                repro_torch.ProblemSpec(points=PTS, k=K, labels=LAB),
                repro_torch.ExecutionSpec(mode="mapreduce", mesh=POD,
                                          recursive=True, device="cpu")),
            "three_round_constrained": lambda: repro_torch.plan(
                repro_torch.ProblemSpec(points=PTS, k=K, labels=LAB),
                repro_torch.ExecutionSpec(mode="mapreduce", mesh=MESH,
                                          three_round=True, device="cpu")),
            "grouped_no_mesh": lambda: mr_grouped_coreset(
                PTS, LAB, 3, K, KP, "remote-edge", None),
            "fair_no_mesh": lambda: (
                repro_torch.constrained.mapreduce._mr_fair_diversity_impl(
                    PTS, LAB, [2, 2, 2])),
            "dtensor_batch": lambda: repro_torch.plan(
                repro_torch.ProblemSpec(points=shard(PTS), k=K),
                repro_torch.ExecutionSpec(mode="batch", device="cpu")),
        }
        for name, fn in tries.items():
            try:
                fn()
                out[name] = None
            except Exception as e:
                out[name] = (type(e).__name__, str(e))
        return out

    def explain():
        out = {}
        for name, (prob, ex) in {
                "plain": (dict(points=PTS, k=K), dict(mesh=MESH, kprime=KP)),
                "auto": (dict(points=PTS, k=K), dict(mesh=MESH)),
                "recursive": (dict(points=PTS, k=K),
                              dict(mesh=POD, recursive=True)),
                "three_round": (dict(points=PTS, k=K,
                                     measure="remote-clique"),
                                dict(mesh=MESH, three_round=True,
                                     kprime=KP)),
                "constrained": (dict(points=PTS, k=K, labels=LAB,
                                     quotas=[2, 2, 2]),
                                dict(mesh=MESH, kprime=KP)),
                "pod_axes": (dict(points=PTS, k=K),
                             dict(mesh=POD, data_axes=("pod", "data"))),
                "dtensor": (dict(points=shard(PTS), k=K), dict()),
        }.items():
            out[name] = repro_torch.plan(
                repro_torch.ProblemSpec(**prob),
                repro_torch.ExecutionSpec(device="cpu", **ex)).explain()
        return out

    def legacy():
        import warnings
        from repro_torch.constrained import mr_fair_diversity
        from repro_torch.core.distributed import mr_diversity
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sol, val = mr_diversity(PTS, K, "remote-edge", MESH, kprime=KP,
                                    b=1, device="cpu")
            fsol, flab, fval = mr_fair_diversity(
                PTS, LAB, [2, 2, 2], mesh=MESH, kprime=KP, b=1,
                device="cpu")
        return {"mr": (np.asarray(sol), float(val)),
                "fair": (np.asarray(fsol), np.asarray(flab), float(fval)),
                "warned": sorted({str(x.category.__name__) for x in w})}

    def order():
        return {"host": [HOST.mesh.tolist(), list(data_axes(HOST)),
                         num_chips(HOST)],
                "pod": [list(data_axes(POD)), num_chips(POD)]}

    def recursive():
        cs, counters = traced(lambda: mr_coreset_recursive(
            PTS, K, KP, "remote-edge", POD, device="cpu"))
        return {"coreset": host(cs), "counters": counters,
                "facade": facade(mesh=POD, recursive=True),
                "facade_dtensor": facade(points=shard(PTS, POD), mesh=POD,
                                         recursive=True)}

    CASES = [(f"coreset_{m}_b{b}", (lambda m=m, b=b: coreset(
        m, 1 if b == "1" else "auto"))) for m in ("plain", "ext", "gen")
        for b in ("1", "auto")]
    CASES += [
        ("facade_plain", lambda: facade()),
        ("facade_ext", lambda: facade(measure="remote-clique")),
        ("facade_auto", lambda: facade(kprime="auto", b="auto")),
        ("facade_strided", lambda: facade(points=BIG, kprime="auto",
                                          b="auto")),
        ("facade_three_round", lambda: facade(measure="remote-clique",
                                              three_round=True)),
        ("facade_lattice", lambda: facade(points=LAT)),
        ("recursive", recursive),
        ("grouped_plain", lambda: grouped("remote-edge")),
        ("grouped_ext", lambda: grouped("remote-clique")),
        ("constrained", lambda: constrained()),
        ("dtensor", lambda: {"plain": facade(points=shard(PTS)),
                             "auto": facade(points=shard(PTS), kprime="auto",
                                            b="auto"),
                             "constrained": constrained(points=shard(PTS))}),
        ("resilience", lambda: {"every": resilient(range(WORLD_SIZE)),
                                "one": resilient((2,))}),
        ("pod_axes", lambda: facade(mesh=POD, data_axes=("pod", "data"))),
        ("data_pod_axes", lambda: facade(mesh=POD,
                                         data_axes=("data", "pod"))),
        ("legacy", legacy),
        ("errors", errors),
        ("explain", explain),
        ("order", order),
        ("probe_plan", lambda: probe(False)),
        ("probe_fault", lambda: probe(True)),
    ]
    failed = run_all(CASES, f"rank{RANK}")
    dist.destroy_process_group()
    print("failed:", failed)
""")

_REFERENCE = _COMMON + textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    import repro
    from repro.constrained import mr_grouped_coreset
    from repro.core.distributed import mr_coreset, mr_coreset_recursive
    from repro.obs.trace import RunTrace, activate

    MESH = jax.make_mesh((4,), ("data",))
    POD = jax.make_mesh((2, 2), ("pod", "data"))

    def traced(fn):
        tr = RunTrace(enabled=True)
        with activate(tr):
            out = fn()
        return out, dict(tr.counters)

    def coreset(mode, b):
        cs, counters = traced(lambda: mr_coreset(
            jnp.asarray(PTS), K, KP, MEASURES[mode], MESH,
            generalized=mode == "gen", b=b))
        return {"coreset": host(cs), "counters": counters}

    def facade(points=PTS, measure="remote-edge", mesh=MESH, **kw):
        kw.setdefault("kprime", KP)
        kw.setdefault("b", 1)
        return result(repro.diversify(
            points, k=K, measure=measure,
            execution=repro.ExecutionSpec(mode="mapreduce", mesh=mesh,
                                          trace=True, **kw)))

    def constrained():
        return result(repro.diversify(
            repro.ProblemSpec(points=PTS, k=K, labels=LAB,
                              quotas=[2, 2, 2]),
            repro.ExecutionSpec(mode="mapreduce", mesh=MESH, kprime=KP,
                                b=1, trace=True)))

    def grouped(measure):
        cs, counters = traced(lambda: mr_grouped_coreset(
            jnp.asarray(PTS), jnp.asarray(LAB), 3, K, KP, measure, MESH))
        return {"coreset": host(cs), "counters": counters}

    def errors():
        out = {}
        tries = {
            "n_mod_l": lambda: mr_coreset(jnp.asarray(PTS[:1998]), K, KP,
                                          "remote-edge", MESH),
            "recursive_no_pod": lambda: repro.plan(
                repro.ProblemSpec(points=PTS, k=K),
                repro.ExecutionSpec(mode="mapreduce", mesh=MESH,
                                    recursive=True)),
            "recursive_constrained": lambda: repro.plan(
                repro.ProblemSpec(points=PTS, k=K, labels=LAB),
                repro.ExecutionSpec(mode="mapreduce", mesh=POD,
                                    recursive=True)),
            "three_round_constrained": lambda: repro.plan(
                repro.ProblemSpec(points=PTS, k=K, labels=LAB),
                repro.ExecutionSpec(mode="mapreduce", mesh=MESH,
                                    three_round=True)),
            "grouped_no_mesh": lambda: mr_grouped_coreset(
                PTS, LAB, 3, K, KP, "remote-edge", None),
            "fair_no_mesh": lambda: (
                repro.constrained.mapreduce._mr_fair_diversity_impl(
                    PTS, LAB, [2, 2, 2])),
        }
        for name, fn in tries.items():
            try:
                fn()
                out[name] = None
            except Exception as e:
                out[name] = (type(e).__name__, str(e))
        return out

    def explain():
        out = {}
        for name, (prob, ex) in {
                "plain": (dict(points=PTS, k=K), dict(mesh=MESH, kprime=KP)),
                "auto": (dict(points=PTS, k=K), dict(mesh=MESH)),
                "recursive": (dict(points=PTS, k=K),
                              dict(mesh=POD, recursive=True)),
                "three_round": (dict(points=PTS, k=K,
                                     measure="remote-clique"),
                                dict(mesh=MESH, three_round=True,
                                     kprime=KP)),
                "constrained": (dict(points=PTS, k=K, labels=LAB,
                                     quotas=[2, 2, 2]),
                                dict(mesh=MESH, kprime=KP)),
                "pod_axes": (dict(points=PTS, k=K),
                             dict(mesh=POD, data_axes=("pod", "data"))),
        }.items():
            out[name] = repro.plan(repro.ProblemSpec(**prob),
                                   repro.ExecutionSpec(**ex)).explain()
        return out

    def recursive():
        cs, counters = traced(lambda: mr_coreset_recursive(
            jnp.asarray(PTS), K, KP, "remote-edge", POD))
        return {"coreset": host(cs), "counters": counters,
                "facade": facade(mesh=POD, recursive=True)}

    CASES = [(f"coreset_{m}_b{b}", (lambda m=m, b=b: coreset(
        m, 1 if b == "1" else "auto"))) for m in ("plain", "ext", "gen")
        for b in ("1", "auto")]
    CASES += [
        ("facade_plain", lambda: facade()),
        ("facade_ext", lambda: facade(measure="remote-clique")),
        ("facade_auto", lambda: facade(kprime="auto", b="auto")),
        ("facade_strided", lambda: facade(points=BIG, kprime="auto",
                                          b="auto")),
        ("facade_three_round", lambda: facade(measure="remote-clique",
                                              three_round=True)),
        ("facade_lattice", lambda: facade(points=LAT)),
        ("recursive", recursive),
        ("grouped_plain", lambda: grouped("remote-edge")),
        ("grouped_ext", lambda: grouped("remote-clique")),
        ("constrained", constrained),
        ("pod_axes", lambda: facade(mesh=POD, data_axes=("pod", "data"))),
        ("data_pod_axes", lambda: facade(mesh=POD,
                                         data_axes=("data", "pod"))),
        ("errors", errors),
        ("explain", explain),
    ]
    print("failed:", run_all(CASES, "ref"))
""")


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Start the four gloo ranks and the reference's 4-device run once;
    return ``load(case, who)`` over their result files."""
    out = tmp_path_factory.mktemp("mesh")
    np.savez(out / "inputs.npz", **_inputs())
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(out), str(r), str(WORLD),
         str(store)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out)], env=ref_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            logs.append((p.returncode, so[-2000:], se[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, so, se in logs:
        assert rc == 0, f"a mesh process exited {rc}:\n{so}\n{se}"

    def load(case, who):
        with open(out / f"{case}.{who}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("trace", res)
        return res
    return load


def _ranks(load, case):
    return [load(case, f"rank{r}") for r in range(WORLD)]


def _assert_tree_equal(a, b, path=""):
    """Equal trees of host values: arrays equal entry for entry (the
    ``torch.equal`` of the tensors they came from)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _host(x):
    if x is None or isinstance(x, (int, float, str, bool)):
        return x
    if dataclasses.is_dataclass(x):
        return {f.name: _host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "_fields"):
        return {f: _host(getattr(x, f)) for f in x._fields}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_cert_close(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in ("kprime", "counts", "b_schedule", "meets_target"):
        _assert_tree_equal(got[f], want[f], f)
    np.testing.assert_allclose([got[f] for f in ("radius", "scale", "ratio")],
                               [want[f] for f in ("radius", "scale",
                                                  "ratio")], rtol=RTOL)


def _valid_rows(cs):
    """The union's rows the solver reads: the valid ones (an invalid EXT
    slot holds zeros in the port and an arbitrary row in the reference)."""
    if "valid" in cs:
        return cs["points"][np.asarray(cs["valid"], bool)]
    return cs["points"]


def _sim_union(mode, b):
    """The port's simulated ℓ = 4 union of the same call."""
    from repro_torch.core.distributed import _simulate_mr_impl
    _, _, cs, _ = _simulate_mr_impl(
        _inputs()["pts"], K, MEASURES[mode], num_reducers=WORLD, kprime=KP,
        generalized=mode == "gen", b=1 if b == "1" else "auto",
        device="cpu")
    return _host(cs)


@pytest.mark.parametrize("case", CORESET_CASES)
def test_mr_coreset_against_simulated_and_reference(mesh_run, case):
    _, mode, b = case.split("_")
    b = b[1:]
    ranks = _ranks(mesh_run, case)
    want = _sim_union(mode, b)
    for got in ranks:
        _assert_tree_equal(got["coreset"], want)
        assert got["counters"] == ranks[0]["counters"]
    ref = mesh_run(case, "ref")
    got, rcs = ranks[0]["coreset"], ref["coreset"]
    np.testing.assert_array_equal(_valid_rows(got), _valid_rows(rcs))
    if mode == "gen":
        np.testing.assert_array_equal(got["multiplicity"],
                                      rcs["multiplicity"])
    np.testing.assert_allclose(got["radius"], rcs["radius"], rtol=RTOL)
    _assert_cert_close(got["cert"], rcs["cert"])
    drop = ("jit_recompiles",) + (("host_syncs",) if b == "auto" else ())
    assert ({k: v for k, v in ranks[0]["counters"].items() if k not in drop}
            == {k: v for k, v in ref["counters"].items() if k not in drop})


def _sim_facade(measure="remote-edge", points=None, labels=None, **kw):
    import repro_torch
    kw.setdefault("kprime", KP)
    kw.setdefault("b", 1)
    data = _inputs()
    prob = dict(points=data["pts"] if points is None else points, k=K,
                measure=measure)
    if labels is not None:
        prob.update(labels=labels, quotas=[2, 2, 2])
    return repro_torch.diversify(
        repro_torch.ProblemSpec(**prob), repro_torch.ExecutionSpec(
            mode="mapreduce", num_reducers=WORLD, device="cpu",
            trace=True, **kw))


def _assert_same_as_simulated(got, sim, *, same_dispatches=True):
    np.testing.assert_array_equal(got["solution"], sim.solution)
    assert got["value"] == sim.value
    if sim.indices is None:
        assert got["indices"] is None
    else:
        np.testing.assert_array_equal(got["indices"], sim.indices)
    _assert_tree_equal(got["cert"], _host(sim.cert))
    if sim.coreset is not None:
        _assert_tree_equal(got["coreset"], _host(sim.coreset))
    drop = () if same_dispatches else ("device_dispatches",)
    assert ({k: v for k, v in got["counters"].items() if k not in drop}
            == {k: v for k, v in sim.telemetry.counters.items()
                if k not in drop})


def _assert_close_to_reference(got, ref, exact_syncs=True, exact=False):
    np.testing.assert_array_equal(got["solution"], ref["solution"])
    _assert_tree_equal(got["indices"], ref["indices"])
    if exact:
        assert got["value"] == ref["value"]
    else:
        np.testing.assert_allclose(got["value"], ref["value"], rtol=RTOL)
    _assert_cert_close(got["cert"], ref["cert"])
    drop = ("jit_recompiles",) + (() if exact_syncs else ("host_syncs",))
    assert ({k: v for k, v in got["counters"].items() if k not in drop}
            == {k: v for k, v in ref["counters"].items() if k not in drop})
    assert got["phases"] == ref["phases"]
    assert got["extras"] == ref["extras"]


@pytest.mark.parametrize("case", FACADE_CASES)
def test_facade_against_simulated_and_reference(mesh_run, case):
    """The facade with ``mesh=`` on a full array every rank holds: the
    simulated run's answer at ℓ = 4 on every rank, the reference's mesh
    answer (three-round: the generalized scheme's)."""
    data = _inputs()
    kw = {"facade_plain": {}, "facade_ext": dict(measure="remote-clique"),
          "facade_auto": dict(kprime="auto", b="auto"),
          "facade_strided": dict(points=data["big"], kprime="auto",
                                 b="auto"),
          "facade_three_round": dict(measure="remote-clique",
                                     generalized=True),
          "facade_lattice": dict(points=data["lattice"])}[case]
    sim = _sim_facade(**kw)
    ranks = _ranks(mesh_run, case)
    for got in ranks:
        # the simulated run charges the generalized scheme's multiplicity
        # re-dispatch (the reference's model), the three-round mesh run not
        _assert_same_as_simulated(got, sim, same_dispatches=case
                                  != "facade_three_round")
    _assert_close_to_reference(ranks[0], mesh_run(case, "ref"),
                               exact_syncs=case not in ("facade_auto",
                                                        "facade_strided"),
                               exact=case == "facade_lattice")
    if case == "facade_lattice":
        assert ranks[0]["coreset"]["radius"] == \
            mesh_run(case, "ref")["coreset"]["radius"]


def _recursive_expected():
    """The recursive scheme built from the simulated run's per-reducer
    units and one masked exact GMM a pod (the public ``core.gmm.gmm``, not
    the mesh path's own level-2 helper)."""
    from repro_torch.core.distributed import _sim_round1
    from repro_torch.core.gmm import gmm
    pts = torch.as_tensor(_inputs()["pts"])
    per = pts.shape[0] // WORLD
    units = [_sim_round1(pts[r * per:(r + 1) * per], 1, K, KP, "euclidean",
                         "plain", 1, 0, None, False) for r in range(WORLD)]
    lvl2, radii = [], []
    for pod in range(2):
        blocks = units[2 * pod:2 * pod + 2]
        pod_pts = torch.cat([u[0][0] for u in blocks])
        pod_mask = torch.cat([u[1][0] for u in blocks])
        res = gmm(pod_pts, KP, metric="euclidean", mask=pod_mask,
                  use_pallas=False, device="cpu")
        lvl2.append(pod_pts[res.idx])
        radii += [res.radius] + [u[2].max() for u in blocks]
    return torch.cat(lvl2), torch.stack(radii).max()


def test_recursive_against_units_and_reference(mesh_run):
    want_pts, want_rad = _recursive_expected()
    ranks = _ranks(mesh_run, "recursive")
    ref = mesh_run("recursive", "ref")
    for got in ranks:
        cs = got["coreset"]
        np.testing.assert_array_equal(cs["points"], want_pts.numpy())
        assert cs["radius"] == want_rad.numpy()
        assert cs["valid"].all() and cs["points"].shape == (2 * KP, 8)
        assert got["counters"] == {}          # pinned knobs, as the reference
        _assert_tree_equal(got["facade"], ranks[0]["facade"])
        for key in ("solution", "value", "indices", "coreset"):
            _assert_tree_equal(got["facade_dtensor"][key],
                               got["facade"][key])
    np.testing.assert_array_equal(ranks[0]["coreset"]["points"],
                                  ref["coreset"]["points"])
    np.testing.assert_allclose(ranks[0]["coreset"]["radius"],
                               ref["coreset"]["radius"], rtol=RTOL)
    assert ranks[0]["facade"]["phases"] == ["rounds", "solve", "value"]
    _assert_close_to_reference(ranks[0]["facade"], ref["facade"])


def _sim_grouped(measure):
    from repro_torch.constrained.mapreduce import _sim_round1
    data = _inputs()
    pts = torch.as_tensor(data["pts"])
    lab = torch.as_tensor(data["labels"]).view(WORLD, -1)
    g_pts, g_lab, g_valid, g_rad = _sim_round1(
        pts, lab, 3, K, KP, "euclidean", "ext" if measure == "remote-clique"
        else "plain", 1, 0, None, False)
    return {"points": g_pts.flatten(0, 1).numpy(),
            "labels": g_lab.flatten().numpy(),
            "valid": g_valid.flatten().numpy(),
            "radius": g_rad.max().numpy(), "cert": None}


@pytest.mark.parametrize("case", ["grouped_plain", "grouped_ext",
                                  "constrained"])
def test_constrained_against_simulated_and_reference(mesh_run, case):
    ranks = _ranks(mesh_run, case)
    ref = mesh_run(case, "ref")
    if case == "constrained":
        sim = _sim_facade(labels=_inputs()["labels"])
        for got in ranks:
            np.testing.assert_array_equal(got["solution"], sim.solution)
            np.testing.assert_array_equal(got["labels"], sim.labels)
            np.testing.assert_array_equal(got["indices"], sim.indices)
            assert got["value"] == sim.value
            assert got["counters"] == dict(sim.telemetry.counters)
        np.testing.assert_array_equal(ranks[0]["solution"], ref["solution"])
        np.testing.assert_array_equal(ranks[0]["labels"], ref["labels"])
        np.testing.assert_array_equal(ranks[0]["indices"], ref["indices"])
        np.testing.assert_allclose(ranks[0]["value"], ref["value"],
                                   rtol=RTOL)
        rc = {k: v for k, v in ref["counters"].items()
              if k != "jit_recompiles"}
        assert ranks[0]["counters"] == rc
        return
    want = _sim_grouped("remote-clique" if case == "grouped_ext"
                        else "remote-edge")
    for got in ranks:
        _assert_tree_equal(got["coreset"], want)
    got, rcs = ranks[0]["coreset"], ref["coreset"]
    v = np.asarray(got["valid"], bool)
    np.testing.assert_array_equal(v, np.asarray(rcs["valid"], bool))
    np.testing.assert_array_equal(got["points"][v], rcs["points"][v])
    np.testing.assert_array_equal(got["labels"], rcs["labels"])
    np.testing.assert_allclose(got["radius"], rcs["radius"], rtol=RTOL)
    assert ranks[0]["counters"] == {k: v for k, v in ref["counters"].items()
                                    if k != "jit_recompiles"}


@pytest.mark.parametrize("part", ["plain", "auto", "constrained"])
def test_dtensor_input_equals_the_full_array(mesh_run, part):
    """A DTensor placed Shard(0) (each rank holding only its rows) gives
    the full array's answer, indices recovered across the ranks."""
    full = {"plain": "facade_plain", "auto": "facade_auto",
            "constrained": "constrained"}[part]
    for r, got in enumerate(_ranks(mesh_run, "dtensor")):
        want = mesh_run(full, f"rank{r}")
        got = got[part]
        for key in ("solution", "value", "indices", "labels", "cert",
                    "coreset", "counters", "phases", "extras"):
            _assert_tree_equal(got[key], want[key], key)
        assert "auto: input array is device-sharded" not in got["explain"]


@pytest.mark.parametrize("who", ["every", "one"])
def test_resilience_retries_round1_on_every_rank(mesh_run, who):
    """An injected round-1 fault (on every rank, or on rank 2 alone) is
    agreed on before the all-gather: every rank retries once and the
    answer is the unfaulted run's."""
    for r, got in enumerate(_ranks(mesh_run, "resilience")):
        got, want = got[who], mesh_run("facade_plain", f"rank{r}")
        for key in ("solution", "value", "indices", "coreset", "cert"):
            _assert_tree_equal(got[key], want[key], key)
        rep = got["resilience"]
        assert rep["scope"] == "round" and rep["retries"] == 1
        fired = who == "every" or r == 2
        assert rep["failures_injected"] == int(fired)
        assert got["counters"].get("retries") == 1
        assert "injector=armed" in got["explain"]


@pytest.mark.parametrize("case", ["probe_plan", "probe_fault"])
def test_only_the_first_reducer_probes(mesh_run, case):
    """The first reducer alone probes the gathered subsample; the others
    take its plan and the counters it added (the same answer as
    ``facade_auto`` on every rank), and a probe that fails there raises
    on every rank instead of leaving them in the broadcast."""
    for r, got in enumerate(_ranks(mesh_run, case)):
        assert got["calls"] == (1 if r == 0 else 0)
        if case == "probe_fault":
            kind, msg = got["raised"]
            assert kind == "RuntimeError" and "injected probe fault" in msg
            assert r == 0 or "probe failed on the first reducer" in msg
            continue
        want = mesh_run("facade_auto", f"rank{r}")
        for key in ("solution", "value", "indices", "coreset", "cert",
                    "counters"):
            _assert_tree_equal(got["result"][key], want[key], key)


@pytest.mark.parametrize("case", ["pod_axes", "data_pod_axes"])
def test_two_data_axes_follow_the_tiled_order(mesh_run, case):
    """Over two data axes the reducers are the four ranks in row-major
    order of the axes as named: over ('data', 'pod') rank (p, q) is
    reducer 2q + p, so the process group's member order (0, 1, 2, 3) is
    not the reducers' (0, 2, 1, 3).  Reducer r holds rows r·per..(r+1)·per
    and its block is block r of the union, so both runs equal the 1-D
    mesh's, and the reference's over the same axes."""
    for r, got in enumerate(_ranks(mesh_run, case)):
        want = mesh_run("facade_plain", f"rank{r}")
        for key in ("solution", "value", "indices", "coreset", "counters"):
            _assert_tree_equal(got[key], want[key], key)
    _assert_close_to_reference(_ranks(mesh_run, case)[0],
                               mesh_run(case, "ref"))


def test_host_mesh_and_legacy_wrappers(mesh_run):
    order = mesh_run("order", "rank0")
    assert order["host"] == [[[0], [1], [2], [3]], ["data"], 4]
    assert order["pod"] == [["pod", "data"], 4]
    for r, got in enumerate(_ranks(mesh_run, "legacy")):
        plain = mesh_run("facade_plain", f"rank{r}")
        fair = mesh_run("constrained", f"rank{r}")
        np.testing.assert_array_equal(got["mr"][0], plain["solution"])
        assert got["mr"][1] == plain["value"]
        np.testing.assert_array_equal(got["fair"][0], fair["solution"])
        np.testing.assert_array_equal(got["fair"][1], fair["labels"])
        assert got["fair"][2] == fair["value"]
        assert got["warned"] == ["DeprecationWarning"]


@pytest.mark.parametrize("case", ["n_mod_l", "recursive_no_pod",
                                  "recursive_constrained",
                                  "three_round_constrained",
                                  "grouped_no_mesh", "fair_no_mesh",
                                  "dtensor_batch"])
def test_errors_match_the_reference(mesh_run, case):
    got = mesh_run("errors", "rank0")[case]
    assert got is not None and got[0] == "ValueError", got
    if case == "dtensor_batch":          # the reference has no DTensor
        assert "full_tensor" in got[1]
        return
    want = mesh_run("errors", "ref")[case]
    if case == "recursive_no_pod":
        # decided difference: the reference's plan() reads mesh.shape['pod']
        assert want[0] == "KeyError"
        assert got[1] == "recursive scheme expects a 'pod' axis"
        return
    assert want == got
    for r in range(1, WORLD):
        assert mesh_run("errors", f"rank{r}")[case] == got


@pytest.mark.parametrize("case", ["plain", "auto", "recursive",
                                  "three_round", "constrained", "pod_axes",
                                  "dtensor"])
def test_explain_matches_the_reference(mesh_run, case):
    got = mesh_run("explain", "rank0")[case]
    ref = mesh_run("explain", "ref")
    if case == "dtensor":
        # a DTensor input is the reference's device-sharded array
        assert "mode: mapreduce (auto: input array is device-sharded)" in got
        assert "layout: mesh torch.distributed over axes ('data',), 4 " \
               "reducers" in got
        return
    want = ref[case]
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if w.startswith("  layout: mesh shard_map"):
            assert g == w.replace("mesh shard_map", "mesh torch.distributed")
        else:
            assert g == w


def test_sweep_invariants_of_a_shard_are_the_shards_of_the_invariants():
    """Each rank computes the sweep invariants of its own rows; they equal
    the slice of the whole input's, for every metric."""
    from repro_torch.core.gmm import _sweep_points
    pts = torch.as_tensor(_inputs()["pts"]) * 3.0 + 1.0
    for metric in ("euclidean", "sqeuclidean", "cosine", "dot",
                   "manhattan"):
        whole = _sweep_points(pts, metric)
        per = pts.shape[0] // WORLD
        for r in range(WORLD):
            part = _sweep_points(pts[r * per:(r + 1) * per], metric)
            assert torch.equal(part.points,
                               whole.points[r * per:(r + 1) * per])
            assert (part.xsq is None) == (whole.xsq is None)
            if part.xsq is not None:
                assert torch.equal(part.xsq, whole.xsq[r * per:(r + 1) * per])
