"""The port's data- and pipeline-parallel training helpers
(``repro_torch.distributed.compression``, ``.pipeline``) on four gloo CPU
ranks, against the reference's on a 4-device CPU mesh and against the
unpipelined stack.

One module fixture starts the four ranks once (a ``file://`` store under
the test's temporary directory, so no TCP port) and, beside them, one
subprocess running the reference's ``psum_bf16`` / ``psum_int8_ef`` in
``shard_map`` on the same per-replica gradients
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  Each writes its
results to a pickle file that the tests below read.

What is held:

* the reference test's bounds (``tests/test_perf_variants.py``): the bf16
  mean within 2e-2 of the exact mean, the int8 mean within 5e-2, the
  error-feedback residual in (0, 0.1);
* the reference's output on the same gradients: the int8 mean (an fp32
  sum of dequantized payloads, in another order) to rtol 1e-6 and 1e-6 of
  the largest entry, the residual equal; the bf16 mean (a sum of bf16
  payloads in bf16: gloo all-reduces bf16 as bf16, in ring order) within
  two bf16 ulps of the largest entry (2 x 2^-7 of it);
* the GPipe schedule on a (4, 1) and a (2, 2) ('pod', ...) mesh, stage
  weights whole or as a DTensor sharded over 'pod', against the
  sequential stack within 1e-5 (``tests/test_pipeline.py``), the same
  output on every rank;
* its gradient: the ranks' loss ``sum(out * gy)`` differentiated through
  ``pipeline_apply`` in each of those cases at num_micro 4 and 8, against
  the reference's ``jax.grad`` through its ``pipeline_apply`` on
  Auto-axes meshes of the same shapes (the subprocess above) within 1e-5
  of the largest entry in fp32, and against torch autograd through the
  unpipelined stack within 1e-12 in float64; the replicated gradients
  (``x``'s, a plain stack's) equal on every rank of the axis, a DTensor
  leaf's local gradient its stage's row; a one-rank axis in float64;
* the reference's error-feedback quadratic (``tests/test_checkpoint_ft.py``)
  through ``psum_int8_ef`` on the ranks.
"""
import pickle
import subprocess
import sys
import textwrap
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest
import torch

from repro_torch.distributed import dequantize_int8, quantize_int8

WORLD = 4
SPAWN_TIMEOUT = 300
BF16_ULP = 2.0 ** -7
# (case, num_micro) of the pipeline's gradient
PIPE_CASES = [(case, nm) for case in ("4x1", "2x2", "2x2_dtensor")
              for nm in (4, 8)]

_RANK = textwrap.dedent("""
    import datetime, os, pickle, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    OUT, RANK, WORLD = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                            rank=RANK, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import (init_error_feedback,
                                         pipeline_apply, psum_bf16,
                                         psum_int8_ef)
    PIPE_CASES = @PIPE_CASES@

    data = dict(np.load(os.path.join(OUT, "inputs.npz")))
    G = torch.as_tensor(data["g"])
    MESH41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "model"))
    MESH22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))

    def compression():
        mean16 = psum_bf16({"w": G[RANK]})["w"]
        errs = init_error_feedback({"w": G[RANK]})
        mean8, new_e = psum_int8_ef({"w": G[RANK]}, errs)
        # over one dimension of a mesh: the 'data' ranks of this 'pod'
        pod = MESH22.get_local_rank("pod")
        sub = psum_bf16({"w": G[RANK]}, MESH22.get_group("data"))["w"]
        return {"bf16": mean16.numpy(), "int8": mean8["w"].numpy(),
                "resid": new_e["w"].numpy(), "bf16_data_axis": sub.numpy(),
                "pod": pod, "dtypes": [str(mean16.dtype),
                                       str(mean8["w"].dtype)]}

    def stage(W, xb):
        return torch.tanh(xb @ W)

    def pipeline():
        Ws, x = torch.as_tensor(data["Ws"]), torch.as_tensor(data["x"])
        out = {"4x1": pipeline_apply(stage, Ws, x, MESH41, axis="pod",
                                     num_micro=4).numpy()}
        sid = MESH22.get_local_rank("pod")
        w2 = DTensor.from_local(Ws[sid:sid + 1], MESH22,
                                [Shard(0), Replicate()], run_check=False)
        out["2x2"] = pipeline_apply(stage, Ws[:2], x, MESH22, axis="pod",
                                    num_micro=4).numpy()
        out["2x2_dtensor"] = pipeline_apply(stage, w2, x, MESH22,
                                            axis="pod", num_micro=8).numpy()
        return out

    def pipeline_grad():
        # the loss sum(out * gy) through the schedule: the gradients of the
        # stage weights and of x, each case at num_micro 4 and 8
        out = {}
        for dt in (torch.float32, torch.float64):
            Ws = torch.as_tensor(data["Ws"]).to(dt)
            x0 = torch.as_tensor(data["x"]).to(dt)
            gy = torch.as_tensor(data["gy"]).to(dt)
            for case, nm in PIPE_CASES:
                mesh = MESH41 if case == "4x1" else MESH22
                S = 4 if case == "4x1" else 2
                sid = mesh.get_local_rank("pod")
                if case == "2x2_dtensor":
                    w = DTensor.from_local(Ws[sid:sid + 1].clone(), mesh,
                                           [Shard(0), Replicate()],
                                           run_check=False)
                else:
                    w = Ws[:S].clone()
                w.requires_grad_()
                x = x0.clone().requires_grad_()
                y = pipeline_apply(stage, w, x, mesh, axis="pod",
                                   num_micro=nm)
                (y * gy).sum().backward()
                gw = w.grad.to_local() if case == "2x2_dtensor" else w.grad
                out[f"{case}/{nm}/{str(dt)[6:]}"] = {
                    "out": y.detach().numpy(), "x": x.grad.numpy(),
                    "w": gw.numpy(), "sid": sid}
        # one stage: over the (4, 1) mesh's 'model' dim, no transfer
        w = Ws[:1].clone().requires_grad_()
        x = x0.clone().requires_grad_()
        y = pipeline_apply(stage, w, x, MESH41, axis="model", num_micro=4)
        (y * gy).sum().backward()
        out["one_stage"] = {"out": y.detach().numpy(), "x": x.grad.numpy(),
                            "w": w.grad.numpy()}
        return out

    def ef_quadratic():
        w = torch.tensor([5.0, -3.0, 2.0])
        target = torch.tensor([1.0, 1.0, 1.0])
        e = {"w": torch.zeros(3)}
        for _ in range(200):
            mean, e = psum_int8_ef({"w": w - target}, e)
            w = w - 0.3 * mean["w"]
        return {"w": w.numpy()}

    failed = []
    for name, fn in (("compression", compression), ("pipeline", pipeline),
                     ("pipeline_grad", pipeline_grad), ("ef", ef_quadratic)):
        try:
            out = fn()
        except Exception as e:
            out = {"error": type(e).__name__, "trace": traceback.format_exc()}
            failed.append(name)
        with open(os.path.join(OUT, f"{name}.rank{RANK}.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
    print("failed:", failed)
""").replace("@PIPE_CASES@", repr(PIPE_CASES))

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed import psum_bf16, psum_int8_ef

    OUT = sys.argv[1]
    g = jnp.asarray(np.load(os.path.join(OUT, "inputs.npz"))["g"])
    mesh = jax.make_mesh((4,), ("data",))
    out16 = shard_map(lambda gl: psum_bf16({"w": gl[0]}, "data")["w"],
                      mesh=mesh, in_specs=P("data"), out_specs=P(),
                      check_vma=False)(g)

    def body_i8(gl, el):
        mean, new_e = psum_int8_ef({"w": gl[0]}, {"w": el[0]}, "data")
        return mean["w"], new_e["w"][None]
    out8, new_e = shard_map(body_i8, mesh=mesh,
                            in_specs=(P("data"), P("data")),
                            out_specs=(P(), P("data")),
                            check_vma=False)(g, jnp.zeros_like(g))
    with open(os.path.join(OUT, "compression.reference.pkl"), "wb") as f:
        pickle.dump({"bf16": np.asarray(out16), "int8": np.asarray(out8),
                     "resid": np.asarray(new_e)}, f)

    # jax.grad of sum(out * gy) through the pipeline on Auto-axes meshes
    # (under the default Explicit axes the reference's gradient raises),
    # and through the sequential stack
    from concurrent.futures import ThreadPoolExecutor
    from jax.sharding import AxisType
    from repro.distributed import pipeline_apply
    data = np.load(os.path.join(OUT, "inputs.npz"))
    Ws, x, gy = (jnp.asarray(data[k]) for k in ("Ws", "x", "gy"))

    def stage(W, xb):
        return jnp.tanh(xb @ W)

    def sequential(W, xx):
        for s in range(W.shape[0]):
            xx = stage(W[s], xx)
        return jnp.sum(xx * gy)

    jobs = {}
    for shape, names in (((4, 1), ("pod", "model")), ((2, 2), ("pod", "data"))):
        mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * 2)
        W, key = Ws[:shape[0]], f"{shape[0]}x{shape[1]}"
        for nm in (4, 8):
            loss = (lambda W, xx, nm=nm, mesh=mesh: jnp.sum(pipeline_apply(
                stage, W, xx, mesh, axis="pod", num_micro=nm) * gy))
            jobs[f"{key}/{nm}"] = (loss, W)
        jobs[f"{key}/sequential"] = (sequential, W)

    def grad(job):
        gw, gx = jax.grad(job[0], argnums=(0, 1))(job[1], x)
        return {"w": np.asarray(gw), "x": np.asarray(gx)}
    # each gradient compiles a program of its own: compile them together
    with ThreadPoolExecutor(len(jobs)) as ex:
        grads = dict(zip(jobs, ex.map(grad, jobs.values())))
    with open(os.path.join(OUT, "pipeline_grad.reference.pkl"), "wb") as f:
        pickle.dump(grads, f)
""")


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """Start the four gloo ranks and the reference's 4-device run once;
    return ``load(case, who)`` over their result files."""
    out = tmp_path_factory.mktemp("train_dist")
    rng = np.random.default_rng(0)
    np.savez(out / "inputs.npz",
             g=rng.normal(size=(WORLD, 256)).astype(np.float32),
             Ws=(rng.normal(size=(4, 32, 32)) / np.sqrt(32))
             .astype(np.float32),
             x=rng.normal(size=(16, 32)).astype(np.float32),
             gy=rng.normal(size=(16, 32)).astype(np.float32))
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(out), str(r), str(WORLD),
         str(store)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
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
        assert rc == 0, f"a process exited {rc}:\n{so}\n{se}"

    def load(case, who):
        with open(out / f"{case}.{who}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("trace", res)
        return res
    load.inputs = dict(np.load(out / "inputs.npz"))
    return load


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_means_hold_the_reference_bounds(ranks_run, rank):
    got = ranks_run("compression", f"rank{rank}")
    exact = ranks_run.inputs["g"].mean(axis=0)
    assert got["dtypes"] == ["torch.float32", "torch.float32"]
    err16 = float(np.abs(got["bf16"] - exact).max())
    err8 = float(np.abs(got["int8"] - exact).max())
    resid = float(np.abs(got["resid"]).max())
    assert err16 < 2e-2, err16
    assert err8 < 5e-2, err8
    assert 0 < resid < 0.1, resid


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_means_match_the_reference(ranks_run, rank):
    got = ranks_run("compression", f"rank{rank}")
    want = ranks_run("compression", "reference")
    scale = float(np.abs(want["int8"]).max())
    np.testing.assert_allclose(got["int8"], want["int8"], rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_array_equal(got["resid"], want["resid"][rank])
    scale = float(np.abs(want["bf16"]).max())
    np.testing.assert_allclose(got["bf16"], want["bf16"], rtol=0,
                               atol=2 * BF16_ULP * scale)


def test_compression_over_a_mesh_dimension(ranks_run):
    """psum_bf16 over the 'data' group of a (2, 2) mesh averages the two
    ranks of each 'pod' only."""
    g = ranks_run.inputs["g"].astype(np.float32)
    for rank in range(WORLD):
        got = ranks_run("compression", f"rank{rank}")
        pod = got["pod"]
        exact = g[2 * pod:2 * pod + 2].mean(axis=0)
        assert float(np.abs(got["bf16_data_axis"] - exact).max()) < 2e-2


@pytest.mark.parametrize("case", ["4x1", "2x2", "2x2_dtensor"])
def test_pipeline_matches_sequential(ranks_run, case):
    Ws = torch.as_tensor(ranks_run.inputs["Ws"])
    ref = torch.as_tensor(ranks_run.inputs["x"])
    for s in range(4 if case == "4x1" else 2):
        ref = torch.tanh(ref @ Ws[s])
    outs = [ranks_run("pipeline", f"rank{r}")[case] for r in range(WORLD)]
    for got in outs:
        assert got.shape == tuple(ref.shape)
        assert float(np.abs(got - ref.numpy()).max()) < 1e-5
        np.testing.assert_array_equal(got, outs[0])


def _pipe_grads(ranks_run, case, nm, dt):
    return [ranks_run("pipeline_grad", f"rank{r}")[f"{case}/{nm}/{dt}"]
            for r in range(WORLD)]


@pytest.mark.parametrize("case,nm", PIPE_CASES)
def test_pipeline_gradient_matches_the_reference(ranks_run, case, nm):
    """fp32: each rank's gradients within 1e-5 (of the largest entry) of
    the reference's jax.grad through its pipeline on an Auto-axes mesh of
    the same shape; the replicated ones equal on every rank."""
    want = ranks_run("pipeline_grad", "reference")
    mesh = "4x1" if case == "4x1" else "2x2"
    ref = want[f"{mesh}/{nm}"]
    seq = want[f"{mesh}/sequential"]
    for k in ("w", "x"):
        scale = max(1.0, float(np.abs(seq[k]).max()))
        assert float(np.abs(ref[k] - seq[k]).max()) <= 1e-5 * scale
    got = _pipe_grads(ranks_run, case, nm, "float32")
    for g in got:
        w_ref = ref["w"][g["sid"]:g["sid"] + 1] if case == "2x2_dtensor" \
            else ref["w"]
        assert g["w"].shape == w_ref.shape and g["x"].shape == ref["x"].shape
        for k, r in (("w", w_ref), ("x", ref["x"])):
            scale = max(1.0, float(np.abs(r).max()))
            assert float(np.abs(g[k] - r).max()) <= 1e-5 * scale, k
        np.testing.assert_array_equal(g["x"], got[0]["x"])
        same = [h for h in got if h["sid"] == g["sid"]]
        np.testing.assert_array_equal(g["w"], same[0]["w"])
        if case != "2x2_dtensor":
            np.testing.assert_array_equal(g["w"], got[0]["w"])


@pytest.mark.parametrize("case,nm", PIPE_CASES)
def test_pipeline_gradient_float64_matches_autograd(ranks_run, case, nm):
    """float64: each rank's output and gradients within 1e-12 of torch
    autograd through the unpipelined stack."""
    S = 4 if case == "4x1" else 2
    inp = ranks_run.inputs
    W = torch.as_tensor(inp["Ws"][:S]).double().requires_grad_()
    x = torch.as_tensor(inp["x"]).double().requires_grad_()
    y = x
    for s in range(S):
        y = torch.tanh(y @ W[s])
    (y * torch.as_tensor(inp["gy"]).double()).sum().backward()
    got = _pipe_grads(ranks_run, case, nm, "float64")
    for g in got:
        w_ref = W.grad[g["sid"]:g["sid"] + 1] if case == "2x2_dtensor" \
            else W.grad
        assert g["w"].dtype == np.float64
        for k, r in (("out", y), ("w", w_ref), ("x", x.grad)):
            err = float(np.abs(g[k] - r.detach().numpy()).max())
            assert err <= 1e-12, (k, err)
        np.testing.assert_array_equal(g["x"], got[0]["x"])


def test_pipeline_gradient_of_one_stage(ranks_run):
    """A one-rank axis runs the stage on each micro-batch in turn, no
    transfer; float64 against autograd within 1e-12."""
    inp = ranks_run.inputs
    W = torch.as_tensor(inp["Ws"][:1]).double().requires_grad_()
    x = torch.as_tensor(inp["x"]).double().requires_grad_()
    y = torch.tanh(x @ W[0])
    (y * torch.as_tensor(inp["gy"]).double()).sum().backward()
    for r in range(WORLD):
        got = ranks_run("pipeline_grad", f"rank{r}")["one_stage"]
        for k, want in (("out", y), ("w", W.grad), ("x", x.grad)):
            assert got[k].shape == tuple(want.shape)
            assert float(np.abs(got[k] - want.detach().numpy()).max()) \
                <= 1e-12, k


@pytest.mark.parametrize("rank", range(WORLD))
def test_error_feedback_converges_across_ranks(ranks_run, rank):
    w = ranks_run("ef", f"rank{rank}")["w"]
    np.testing.assert_allclose(w, [1.0, 1.0, 1.0], atol=1e-2)


# -- one process: the reference's tests/test_checkpoint_ft.py cases ----------

def test_int8_quantization_error_bound():
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(256,))
                        .astype(np.float32))
    q, scale = quantize_int8(g)
    assert q.dtype == torch.int8
    back = dequantize_int8(q, scale)
    assert float((back - g).abs().max()) <= float(scale) / 2 + 1e-6


def test_error_feedback_unbiased_over_time():
    """EF-SGD on a quadratic: compressed path converges to the optimum."""
    w = torch.tensor([5.0, -3.0, 2.0])
    target = torch.tensor([1.0, 1.0, 1.0])
    e = torch.zeros(3)
    for _ in range(200):
        g = w - target
        gq, scale = quantize_int8(g + e)
        deq = dequantize_int8(gq, scale)
        e = g + e - deq
        w = w - 0.3 * deq
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_quantize_matches_the_reference():
    import jax.numpy as jnp
    from repro.distributed import dequantize_int8 as ref_deq
    from repro.distributed import quantize_int8 as ref_quant
    g = (np.random.default_rng(1).normal(size=(512,)) * 3).astype(np.float32)
    g[:4] = [0.0, 127.5, -127.5, 1e-9]
    rq, rs = ref_quant(jnp.asarray(g))
    q, s = quantize_int8(torch.as_tensor(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_deq(rq, rs)))
